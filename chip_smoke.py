#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``avenir_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``avenir_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card and times both (K1 and K2 at each of their
table routes, with a hot-cell case and K2 over the whole int32 range, by
call time, by the kernel's own device time and at one row, the launch
floor, all by ``avenir_tpu_torch/timing.py``; K3 at its split and unsplit
routes and over a grid of query and candidate counts, the crossover behind
the fused engine's gate; the merge of K3's candidate segments, K3m, at the
main path's segment lists, at the serving batches' (lists out, and keys
out in place into list 0), at K3's most segments for one query (257 lists,
k = 16 and 64) and at one row of one list (its launch floor), each with
the ``merge_plan`` it took; K3's keys-out form with an index base, beside
its cross term's ``torch.matmul``, and the merge's keys-out form at a ring
hop's and a model shard's shapes), then drives every ported
path on the card and again on the CPU:

1. telecom-churn Naive Bayes at the repo's benchmark size (50,000 seeded
   rows repeated to 2,000,000; the first 1.6M train in 131,072-row chunks,
   the last 400k are scored): cold training (the native C ingest, then
   kernel K1), the same training with the ingest cache on and then warm
   off the cache (kernel K2, then held at the cache's own first chunk),
   and float64 / float32 scoring, with and without
   ``output.feature.prob.only`` (and each scorer's device time with XLA's
   float math against torch's exp/log); then the native ingest at
   ``ingest.parse.threads`` 1 and 4 (rows/s, the encoder's share, the
   device's idle share; the model held to the numpy-encoded one), kill ->
   ``--resume`` after an ``h2d@9`` fault and a ``worker_death@8`` (and a
   sidecar carried card to CPU and back), a checkpointed run's rate, and row
   quarantine of 300 malformed rows under ``ingest.error.budget=0.01``
   (model and sidecar, card against CPU);
2. the kNN classification job at the width of the repo's kNN benchmark
   (16,384 training and 16,384 test rows of 256 numeric features,
   ``output.top.matches=16``, kernel K3 and its segment merge), then
   top-16 voting, through ``avenir_tpu_torch.cli.main``;
3. the ``resource/knn_classify/run.sh`` sequence at its 120-row size;
4. ``mesh``: the multi-device engines on meshes that name cuda:0 up to
   four times (every hop and launch of the four-device program; no bytes
   move between cards): ``pairwise_topk_ring`` at the kNN width on
   [cuda:0] and [cuda:0] * 4 (``bins``: K3 with an index base and the
   keys-out merge on every hop, d^2 launches of each, the one-device
   answer; ``sort`` on 2,048 queries against the plain engine), and on
   four shards at the segmented shape of bench.py:1244 (2,048 x 1,050,000
   x 64); the 2-D fused engine as 2 x 2 and 1 x 4; the distance job on a
   2 x 2 mesh (the one-device job's bytes); the NB count over four shards
   of the first training chunk (one K1 launch a shard, the one-shard
   table); with each call's time, per-hop device times and the device's
   idle share;
5. ``serve_nb``: ``resource/serving/run.sh`` on the card — the churn
   artifact trained (telecom_churn 3000, seed 29, 2,400 rows), then
   ``python -m avenir_tpu_torch serve`` started as a subprocess with the
   runbook's serve.properties (variants f32,f64, two replicas, batches up
   to 64, warmup at every power-of-two bucket) on an ephemeral port; the
   600 test rows from 16 concurrent single-row clients and batch requests
   of 1 to 64 rows under both variants, each response byte-identical to
   the batch ``BayesianPredictor`` line on the card, no scorer built after
   warmup, SIGINT draining the server into its ``--trace``; then 128 of
   the same requests in process under ``torch.profiler`` (device busy
   time, device events per batch);
6. ``serve_knn``: an in-process server on cuda:0 with a
   ``nearestNeighbor`` model over the kNN job's 16,384 x 256 training set
   (k = 16, batches up to 64), 512 queries in requests of 1 to 64 rows:
   responses equal to the batch job's voting lines within the one-unit
   contract, one K3 launch per batch and no plain-version call, the
   training tensors resident; K3 is also held against its plain version
   at the server's batch sizes (1, 8 and 64 queries).
7. ``nb_runbooks``: ``resource/elearn_nb`` and ``resource/usage_churn_nb``
   at their sizes through the command line;
8. ``apriori``: ``resource/freq_items/run.sh``'s steps through the command
   line, then bench.py:507's Apriori cell at full width (1M transactions
   over 50,000 items, threshold 0.003, count mode, k = 1-5) cold and warm
   (the incidence resident), with its census (|F2| >= 1,000, the three
   planted 5-itemsets at k = 5), the k-pass times and the support matmul's
   device time, and its first 100,000 transactions on the card and on the
   CPU;
9. ``markov``: ``resource/churn_markov/run.sh`` and
   ``resource/hmm_viterbi/run.sh``'s steps through the command line, then
   the family at a real size from vectorized generators of the same
   chains: the trainer streamed over 500,000 sequences (cold, then warm
   off the pair cache), the classifier at float64 and float32 on 100,000,
   the HMM builder on 200,000 tagged rows and Viterbi on 100,000;
10. ``serve_markov``: ``python -m avenir_tpu_torch serve`` with the
   churn_markov model as a ``markovClassifier`` in f32 and f64 variants,
   16 concurrent single-row clients and batch requests of 1-64 rows, each
   response byte-identical to the batch classifier's line, no scorer
   built after warmup;
11. ``mi_corr``: ``resource/hosp_readmit_mi``, ``resource/churn_cramer``
   and ``resource/correlation_suite``'s two correlation legs through the
   command line, then bench.py:840's shared-scan cell (400,000 churn rows,
   the all-binned schema): MI monolithic (one K1 launch), streamed in
   65,536-row chunks writing the ingest cache (one K1 launch a chunk) and
   warm off it, and Cramer;
12. ``multiscan``: ``resource/multiscan/run.sh``'s four jobs through
   ``python -m avenir_tpu_torch multi``, ``resource/fisher_discriminant``
   and ``resource/correlation_suite``'s NumericalAttrStats leg, on the card
   and on the CPU; then bench.py:840's cell (the same 400,000 rows in
   65,536-row chunks at depth 2): NB, MI and Cramer standalone and fused
   in turns (fused / standalone seconds, H2D copies a chunk, K1's launches
   fused = NB's + MI's, K2 none, the fused pass's device idle share), the
   four-job manifest (+ NumericalAttrStats) cold, warm off the tee'd
   ingest cache and on the CPU, and killed by a ``worker_death@3`` and
   resumed, every output equal to its standalone run; the fold
   certificate (``core.algebra.run_dynamic``) on [cuda:0] and
   [cuda:0] * 4; K1 at the fused pass's chunk;
13. ``tree``: ``resource/decision_tree`` (three levels) and
   ``resource/retarget_tree`` through the command line (``decpath.json``,
   every level's records, the ``split=.../segment=...`` tree), bench.py:1327's
   level pass at full width (2,000,000 rows x 64 predicates x 8 paths x 2
   classes; its first 200,000 rows against the CPU, its total against the
   closed form), ``DecisionTreeBuilder`` streamed over 1,000,000 retarget
   rows, and ``serve_tree``: the runbook's tree as a ``decisionTree`` model
   behind ``python -m avenir_tpu_torch serve``, 16 single-row clients and
   batches of 1-64, each response equal to the CPU route;
14. ``pst``: ``resource/visit_pst``, then 200,000 visit rows (windows 2-4)
   on cuda:0, on a mesh of [cuda:0] * 4 (the halo) and on the CPU;
15. ``text``: ``resource/word_count`` and ``resource/text_classify``, then
   200,000 text rows: NB text training (one K1 launch at F = 1), scoring
   and ``WordCounter``; K1 is held to its plain version at the text shape
   (the runbook's 22 tokens, and 2,000,000 tokens over a 40,000-token
   vocabulary, the cluster route);
16. ``regress``: ``resource/logistic_regression``'s loop (the same
   iteration as the CPU, histories within rtol 1e-9), then gen.py's rows at
   1,000,000 for 10 iterations on one resident batch, with the seconds per
   iteration;
17. ``dag_paths``: ``resource/workflow/run.sh``'s steps through ``python
   -m avenir_tpu_torch dag`` at its own size (250,000 churn rows, 8
   stages) on the card and on the CPU (every output equal, publish ==
   retrain, the cost model's FUSE line, the memory handoffs, K1 3 x 13);
   bench.py:938's cell (400,000 rows, 65,536-row chunks, depth 2, six
   stages) as a DAG against the standalone chain with file handoff (byte
   parity, then the best of 2 each), K1 14 in the fused group and 21 in
   the cell, two H2D copies a fused chunk, the idle share; the runbook's
   workflow killed by ``worker_death@5`` in the fused group and resumed
   (``bin`` skipped, the scan resumed mid-file, the clean bytes); K1 at
   the retrain stage's chunk;
18. ``host_jobs``: the class_balance, event_burst, event_seq_gsp,
   bandit_variants and price_optimize runbooks through the port
   (``avenir_tpu_torch.runbook``: rewritten scratch copies in
   subprocesses, four at once) on the card and on the CPU, every file
   equal; ``BanditFeedbackAggregator`` over 1M events on the card and on
   the CPU (equal bytes, rows/s, idle share); ``bandit_fb``'s fold
   certificate on [cuda:0] and [cuda:0] * 4.  Phases 7-18 launch no kernel
   of the port but K1 (the NB runbooks' training, MI, the shared scan, NB
   text training, the DAG's NB and MI folds); each prints its host-clock
   times and a ``torch.profiler`` device-busy and idle share.

Kernel counts (and the native encoder's call count) are set to 0 just
before each path and read just after.
Outputs must be byte-identical between the card and the CPU (phases 7-9
and 11-15 compare every output; the regression's float64 histories agree
within rtol 1e-9, the reference's own tolerance), except kNN
pair lines whose distance lands on an int-scale rounding boundary: those
may differ by one unit, and a float64 oracle must confirm them.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is a JSON object with one entry per kernel and shape.
Any failure raises and the script exits non-zero; without a CUDA device it
exits 2 before doing anything.  Work files go to ``build/chip_smoke/``.
"""

import contextlib
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import time

from avenir_tpu_torch.timing import kernel_device_ms, time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SCHEMA = os.path.join(ROOT, "resource", "churn_nb", "teleComChurn.json")
KNN_RUNBOOK = os.path.join(ROOT, "resource", "knn_classify")

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12      # float32 outside the tensor cores
COUNT_KERNEL = ("avenir_tpu_torch/csrc/histogram.cu",
                "avenir_tpu/ops/pallas_count.py:53")
TOPK_KERNEL = ("avenir_tpu_torch/csrc/topk.cu",
               "avenir_tpu/ops/pallas_topk.py:226")
# the merge of K3's candidate segments: on the TPU the segments' lists
# were merged outside the Pallas kernel by _lex_merge (pallas_topk.py:402)
MERGE_KERNEL = ("avenir_tpu_torch/csrc/topk.cu",
                "avenir_tpu/ops/pallas_topk.py:402")

BASE_ROWS, TOTAL_ROWS, TRAIN_ROWS = 50_000, 2_000_000, 1_600_000
CHUNK_ROWS = 131_072
NB_CFG = {"feature.schema.file.path": SCHEMA,
          "pipeline.chunk.rows": str(CHUNK_ROWS)}
NB_CACHE_CFG = dict(NB_CFG, **{"ingest.cache.enable": "true",
                               "ingest.cache.dir":
                                   os.path.join(WORK, "ingestcache")})
KNN_ROWS, KNN_F, KNN_K = 16_384, 256, 16
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
# K2's int32-range case: small, odd and the largest widths, and enough bins
# (a 128 KB table, one block's) that quotients up to 2,047 are counted
EXTREME_WIDTHS = (1, 2, 7, 200, 65_537, 1_000_000_007, 2 ** 30, I32_MAX)
B_EXTREME = 2048
EXACT_CDIST = "donot_use_mm_for_euclid_dist"   # differences, not the expansion


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def read_bytes(path: str) -> bytes:
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def run_job(argv) -> str:
    """One job through the port's command line; returns its counters
    (the text it prints to standard error)."""
    from avenir_tpu_torch.cli import main as cli_main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli_main(list(argv))
    if rc != 0:
        raise AssertionError(f"job {argv[0]} exited {rc}: {err.getvalue()}")
    return err.getvalue()


def counter(text: str, group: str, name: str) -> int:
    for line in text.splitlines():
        parts = line.split("\t")
        if parts[:2] == [group, name]:
            return int(parts[2])
    raise AssertionError(f"counter {group}/{name} not printed:\n{text}")


# ---------------------------------------------------------------------------
# K1 / K2: the histogram kernel
# ---------------------------------------------------------------------------

def main_path_chunk(train_dir: str):
    """The first training chunk exactly as the cold streamed trainer hands
    it to K1 (int8 codes, -1 in the Gaussian column, no mask), the
    trainer's table extents and its K2 widths: ``(x, y, n_class, bins,
    widths)``."""
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import _NBStreamState, rawbin_widths

    enc = DatasetEncoder(FeatureSchema.from_file(SCHEMA))
    x, values, y, n = next(enc.encode_path_chunks(train_dir, ",",
                                                  chunk_rows=CHUNK_ROWS))
    st = _NBStreamState(enc)
    st.size_caps(x)
    xs, ys = st.accept(x, values, y, n)
    return xs, ys, st.n_class_cap, st.bins_cap, rawbin_widths(enc)


def main_path_warm_chunk(torch, train_dir: str, cache_cfg: dict):
    """K2's case on the main path's first warm chunk: the ingest cache
    that the cache-writing run left, read as ``_train_warm`` reads it
    (the pre-bin raw int32 matrix off mmap, the narrowed class column, no
    mask) at the trainer's widths and extents."""
    import numpy as np

    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.ingestcache import IngestCache
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import _NBStreamState, rawbin_widths

    cfg = JobConfig(dict(cache_cfg))
    enc = DatasetEncoder(FeatureSchema.from_file(SCHEMA))
    scan = IngestCache.from_config(cfg, train_dir, enc,
                                   cfg.field_delim_regex()).load(CHUNK_ROWS)
    if scan is None or scan.xraw is None:
        raise AssertionError("the cache-writing run left no raw matrix")
    scan.seed_encoder(enc)
    st = _NBStreamState(enc)
    xraw, x, values, y, n, _ = next(scan.chunks(with_raw=True))
    st.size_caps(x)
    _, ys = st.accept(x, values, y, n)
    xraw = torch.from_numpy(np.array(xraw, dtype=np.int32))   # off mmap
    ys = torch.from_numpy(ys)
    return ("K2", "main-path warm chunk 0", st.n_class_cap, st.bins_cap,
            rawbin_widths(enc), lambda: (xraw.cuda(), ys.cuda(), None))


def histogram_cases(torch, chunk):
    """``(kid, tag, C, B, widths, make_inputs)`` for every shape K1 and K2
    are held at before the main paths run: the main path's first cold
    chunk (its real codes), the whole churn training set, the same shape
    with every row in one cell (the atomics' worst case) and the wide
    table of the reference's wide-count benchmark (bench.py:1427), with
    masks, -1 codes, out-of-range bins and classes; a 256 KB table, too
    large for a block's shared memory, which takes the cluster route; a
    2 MB table, too large for a cluster's, which takes the global route;
    and K2 over edge and random values of the whole int32 range at widths
    up to 2^31 - 1.  K2's main-path chunk exists only once the cache is
    written (``main_path_warm_chunk``)."""
    import numpy as np

    from avenir_tpu_torch.ops.counting import bin_raw

    xs, ys, C, B, churn_w = chunk
    F = xs.shape[1]

    def real():
        return (torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda(),
                None)

    def synth(n, F, C, dtype, lo, hi, seed):
        def make():
            g = torch.Generator(device="cuda").manual_seed(seed)
            x = torch.randint(lo, hi, (n, F), generator=g,
                              device="cuda").to(dtype)
            y = torch.randint(-1, C + 1, (n,), generator=g,
                              device="cuda").to(dtype)
            mask = torch.rand(n, generator=g, device="cuda") < 0.9
            return x, y, mask
        return make

    def hot():
        return (torch.full((TRAIN_ROWS, F), B // 2, dtype=torch.int8,
                           device="cuda"),
                torch.full((TRAIN_ROWS,), C - 1, dtype=torch.int8,
                           device="cuda"), None)

    def extremes():
        """K2 over the whole int32 range: per column a width (1 to
        2^31 - 1), half the rows from the column's edge values (0, +-1,
        INT32_MIN, INT32_MAX, and -1, 0, +1 around every multiple k*w,
        k <= B, of both signs) and half random int32.  The plain binning
        is first held to Java truncation in int64 on the host."""
        rng = np.random.default_rng(8)
        n = 1 << 20
        cols = []
        for w in EXTREME_WIDTHS:
            k = np.arange(B_EXTREME + 1, dtype=np.int64)[:, None] * w
            edges = np.concatenate([
                [0, 1, -1, I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1],
                (k + np.array([-1, 0, 1])).ravel()])
            edges = np.concatenate([edges, -edges])
            edges = edges[(edges >= I32_MIN) & (edges <= I32_MAX)]
            cols.append(np.where(rng.random(n) < 0.5,
                                 rng.choice(edges, n),
                                 rng.integers(I32_MIN, I32_MAX, n,
                                              endpoint=True)))
        raw = np.stack(cols, axis=1)
        w = np.asarray(EXTREME_WIDTHS, np.int64)[None, :]
        java = np.sign(raw) * (np.abs(raw) // w)
        x = torch.from_numpy(raw.astype(np.int32)).cuda()
        if not np.array_equal(bin_raw(x, EXTREME_WIDTHS).cpu().numpy(),
                              java):
            raise AssertionError("bin_raw is not Java truncation on the "
                                 "card")
        y = torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32)).cuda()
        mask = torch.from_numpy(rng.random(n) < 0.9).cuda()
        return x, y, mask

    i8, i32 = torch.int8, torch.int32
    wide_w = tuple(1 + (7 * f) % 40 for f in range(32))
    return [
        ("K1", "main-path chunk 0", C, B, None, real),
        ("K1", "churn", C, B, None, synth(TRAIN_ROWS, F, C, i8, -1, B + 2, 1)),
        ("K1", "hot cell: churn shape, one class and one code", C, B, None,
         hot),
        ("K1", "wide", 8, 32, None, synth(TOTAL_ROWS, 32, 8, i32, -1, 34, 2)),
        ("K1", "256 KB table", 8, 128, None,
         synth(1 << 18, 64, 8, i32, -1, 130, 3)),
        ("K1", "2 MB table", 8, 1024, None,
         synth(1 << 18, 64, 8, i32, -1, 1026, 6)),
        # the warm path's dtype and widths; raw values past the top bin
        ("K2", "churn", C, B, churn_w,
         synth(TRAIN_ROWS, F, C, i32, -40, B * max(churn_w), 4)),
        ("K2", "wide", 8, 32, wide_w,
         synth(TOTAL_ROWS, 32, 8, i32, -400, 1300, 5)),
        ("K2", "int32 extremes: INT32_MIN/MAX, +-(k*w+-1), widths to 2^31-1",
         2, B_EXTREME, EXTREME_WIDTHS, extremes),
    ]


def run_histogram_case(torch, histogram, kid, tag, C, B, widths,
                       make_inputs) -> dict:
    """Hold K1 or K2 against its plain version on the same inputs (exact
    equality: the counts are integers); time the call (``ms``), the
    kernel's own device time (``device_ms``), both again at one row
    (``floor_ms``, ``floor_device_ms``: the launch floor), the plain
    version and ``torch.bincount`` over the composite key; compute the
    bound."""
    x, y, mask = make_inputs()
    n, F = x.shape
    dev = x.device

    k1 = widths is None

    def call(x, y, mask, out=None):
        if k1:
            return histogram.wide_feature_class_counts(x, y, C, B, mask=mask,
                                                       out=out)
        return histogram.wide_feature_class_counts_rawbin(
            x, y, C, B, widths, mask=mask, out=out)

    kern = lambda out=None: call(x, y, mask, out)
    if k1:
        plain = lambda: histogram.plain_feature_class_counts(x, y, C, B, mask)
        binned = x.long()
        name = "wide_feature_class_counts"
    else:
        plain = lambda: histogram.plain_feature_class_counts_rawbin(
            x, y, C, B, widths, mask)
        wt = torch.tensor(widths, dtype=torch.int32, device=dev)
        binned = torch.div(x.to(torch.int32), wt[None, :],
                           rounding_mode="trunc").long()
        name = "wide_feature_class_counts_rawbin"

    got = kern()
    want = plain()
    torch.cuda.synchronize()
    max_abs_err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{kid} at {tag} differs from its plain "
                             f"version (max abs err {max_abs_err})")
    if int(got.sum()) == 0:
        raise AssertionError(f"{kid} at {tag} counted nothing")

    # the library yardstick: one bincount over the precomputed composite
    # key of the valid elements
    yl = y.long()[:, None].expand(n, F)
    valid = (binned >= 0) & (binned < B) & (yl >= 0) & (yl < C)
    if mask is not None:
        valid &= mask[:, None]
    key = ((yl * F + torch.arange(F, device=dev)[None, :]) * B + binned)[valid]
    lib_out = torch.bincount(key, minlength=C * F * B).view(C, F, B)
    if not torch.equal(lib_out.to(torch.int32), want):
        raise AssertionError(f"bincount yardstick disagrees at {tag}")

    acc = torch.zeros((C, F, B), dtype=torch.int32, device=dev)
    ms = time_ms(lambda: kern(out=acc), 200, warmup_s=0.2)
    device_ms = kernel_device_ms(lambda: kern(out=acc), 50,
                                 "histogram_kernel")
    one = (x[:1], y[:1], None if mask is None else mask[:1])
    floor_ms = time_ms(lambda: call(*one, out=acc), 200,
                       warmup_s=0.2)
    floor_device_ms = kernel_device_ms(lambda: call(*one, out=acc),
                                       50, "histogram_kernel")
    plan = histogram.histogram_plan(
        n, F, C, B, x.element_size(),
        *histogram._device_info(dev.index), rawbin=not k1)
    table = histogram.ROUTES[plan.route] + (
        f" of {plan.cluster} blocks" if plan.cluster > 1 else "")
    plain_ms = time_ms(plain, 5)
    library_ms = time_ms(lambda: torch.bincount(
        key, minlength=C * F * B), 20)

    nbytes = (n * F * x.element_size() + n * y.element_size()
              + (n if mask is not None else 0)
              + (4 * F if widths else 0) + 4 * C * F * B)
    # per element: class test, bin test (plus the division for K2), add
    bound_ms, bound_by = bound(nbytes, n * F * (4 if widths else 3))
    dtype = str(x.dtype).replace("torch.", "")
    masked = ", mask" if mask is not None else ""
    del x, y, mask, got, want, binned, key, valid, acc, one
    torch.cuda.empty_cache()
    return {"name": f"{kid[:2]} {name} [{tag}: n={n} F={F} C={C} B={B} "
                    f"{dtype}{masked}]",
            "route": "cuda", "source": COUNT_KERNEL[0],
            "replaces": COUNT_KERNEL[1], "kid": kid,
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "device_ms": device_ms, "floor_ms": floor_ms,
            "floor_device_ms": floor_device_ms, "table": table,
            "grid": plan.grid, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# K3: fused distance + exact top-k
# ---------------------------------------------------------------------------

def topk_uniform(torch, nq, nt, F, C, seed, cat_w=None):
    """A maker of seeded uniform operands on the card: F numeric columns
    in [0, 1), C categorical columns of 4 codes weighted ``cat_w``."""
    def make():
        g = torch.Generator(device="cuda").manual_seed(seed)
        qn = torch.rand((nq, F), generator=g, device="cuda")
        tn = torch.rand((nt, F), generator=g, device="cuda")
        qc = torch.randint(0, 4, (nq, C), generator=g, device="cuda",
                           dtype=torch.int32)
        tc = torch.randint(0, 4, (nt, C), generator=g, device="cuda",
                           dtype=torch.int32)
        cw = torch.tensor(cat_w if cat_w else [1.0] * C,
                          dtype=torch.float32, device="cuda")
        return qn, qc, tn, tc, cw, float(F + float(cw.sum()))
    return make


def topk_cases(torch):
    """``(tag, algorithm, k, exact, sample, make, split)`` for every shape
    K3 is held at.  ``make`` gives weight-folded operands on the card
    ``(qn, qc, tn, tc, cat_w, wsum)``; ``exact`` where the arithmetic is
    exact (integer-valued or duplicated inputs, pure categorical, the
    left-to-right manhattan sum) or the tolerance of bench.py:1136-1156
    applies; ``sample`` compares only the first rows with the plain
    version; ``split`` forces the number of candidate segments (None:
    ``ops.topk.k3_plan``'s choice)."""
    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def uniform(*args, **kw):
        return topk_uniform(torch, *args, **kw)

    def ties():
        # integer-valued features, every candidate row 8 times: large
        # groups of equal distances, all sums exact
        g = gen(6)
        qn = torch.randint(0, 8, (4096, 16), generator=g,
                           device="cuda").float()
        base = torch.randint(0, 8, (8192, 16), generator=g, device="cuda")
        tn = base.repeat_interleave(8, dim=0).float()
        e = torch.zeros((4096, 0), dtype=torch.int32, device="cuda")
        et = torch.zeros((tn.shape[0], 0), dtype=torch.int32, device="cuda")
        return qn, e, tn, et, torch.zeros(0, device="cuda"), 16.0

    def adversarial():
        # tests/test_pallas_topk.py:68-84 at scale: the 12 nearest
        # candidates sit at stride 128, the layout that overflows one of
        # the Pallas kernel's bins and makes every row suspect there
        nt = 65536
        tn = torch.ones((nt, 2), device="cuda")
        tn[torch.arange(0, nt, 128, device="cuda")[:12]] = 0.0
        qn = torch.zeros((1024, 2), device="cuda")
        e = torch.zeros((1024, 0), dtype=torch.int32, device="cuda")
        et = torch.zeros((nt, 0), dtype=torch.int32, device="cuda")
        return qn, e, tn, et, torch.zeros(0, device="cuda"), 2.0

    return [
        ("main path: the kNN job's shape, bench.py:1119", "euclidean",
         KNN_K, False, None, uniform(KNN_ROWS, KNN_ROWS, KNN_F, 0, 1), None),
        ("one segment (forced) at the main path's shape", "euclidean", KNN_K,
         False, None, uniform(KNN_ROWS, KNN_ROWS, KNN_F, 0, 1), 1),
        ("split axis at a small query count", "euclidean", KNN_K, False,
         None, uniform(64, 65536, KNN_F, 0, 9), None),
        ("mixed numeric + 4 weighted categorical", "euclidean", 9, False,
         None, uniform(4096, 65536, 32, 4, 2, [0.5, 1.0, 1.5, 2.0]), None),
        ("manhattan", "manhattan", 16, True, None,
         uniform(4096, 16384, 64, 0, 3), None),
        ("pure categorical", "euclidean", 5, True, None,
         uniform(4096, 65536, 0, 8, 4, [0.5, 0.75, 1.0, 1.25, 1.5, 1.75,
                                        2.0, 3.0]), None),
        ("k=64", "euclidean", 64, False, None,
         uniform(2048, KNN_ROWS, KNN_F, 0, 5), None),
        ("duplicated candidate rows (ties)", "euclidean", 32, True, None,
         ties, None),
        ("stride-128 adversarial layout", "euclidean", 8, True, None,
         adversarial, None),
        ("segmented axis, bench.py:1244", "euclidean", KNN_K, False, 256,
         uniform(2048, 1_050_000, 64, 0, 7), None),
    ]


def oracle_topk(torch, qn, qc, tn, tc, cw, wsum, algorithm, scale=1000):
    """Float64 int-scaled distances ``[nq, nt]`` of weight-folded
    operands, on the card."""
    q, t = qn.double(), tn.double()
    if q.shape[1] == 0:
        num = torch.zeros((q.shape[0], t.shape[0]), dtype=torch.float64,
                          device=q.device)
    elif algorithm == "euclidean":
        num = torch.cdist(q, t, compute_mode=EXACT_CDIST) ** 2
    else:
        num = torch.cdist(q, t, p=1)
    for c in range(qc.shape[1]):
        num = num + (qc[:, c:c + 1] != tc[None, :, c]).double() * float(cw[c])
    d = num / wsum
    if algorithm == "euclidean":
        d = torch.sqrt(d.clamp_min(0))
    return (d * scale).floor().long()


def topk_agree(torch, got, want, ops, algorithm, exact, label):
    """The reference's tolerance (bench.py:1136-1156): values within one
    unit; rows whose selections differ stay under 1% and each carries, at
    both index sets, float64-oracle distances within one unit of the
    oracle's own k smallest.  Exact equality where ``exact``.  Returns
    ``(max_abs_err, rows that differ)``."""
    (gv, gi), (wv, wi) = got, want
    err = int((gv.long() - wv.long()).abs().max()) if gv.numel() else 0
    rows = torch.nonzero(((gv != wv) | (gi != wi)).any(1)).flatten()
    if exact and (err or rows.numel()):
        raise AssertionError(f"K3 [{label}] differs from its plain version "
                             f"where the arithmetic is exact ({rows.numel()} "
                             f"rows, max abs err {err})")
    if err > 1 or rows.numel() > max(1, gv.shape[0] // 100):
        raise AssertionError(f"K3 [{label}]: max abs err {err}, "
                             f"{rows.numel()} rows differ")
    qn, qc, tn, tc, cw, wsum = ops
    k = gv.shape[1]
    for r in rows.tolist():
        d = oracle_topk(torch, qn[r:r + 1], qc[r:r + 1], tn, tc, cw, wsum,
                        algorithm)[0]
        best = torch.sort(d).values[:k]
        for idx in (gi[r], wi[r]):
            if int((torch.sort(d[idx.long()]).values - best).abs().max()) > 1:
                raise AssertionError(f"K3 [{label}] row {r}: the selected "
                                     f"indices carry wrong oracle distances")
    return err, rows.numel()


def chunked_matmul(torch, qn, tn):
    """The cross term ``qn @ tn.T`` as one ``torch.matmul``, or, where its
    float32 output would pass 1 GB, in candidate chunks of that size."""
    step = max(1, (1 << 28) // max(qn.shape[0], 1))
    if tn.shape[0] <= step:
        return lambda: torch.matmul(qn, tn.T)

    def chunks():
        for a in range(0, tn.shape[0], step):
            torch.matmul(qn, tn[a:a + step].T)
    return chunks


def run_topk_case(torch, topk, tag, algorithm, k, exact, sample, make,
                  split=None, kid="K3", device_time=True) -> dict:
    """Hold K3 against its plain version, time both, K3's own device time
    (``torch.profiler``) and the cross term's ``torch.matmul`` (a partial
    floor: the product alone), and compute the bound."""
    qn, qc, tn, tc, cw, wsum = make()
    nq, nt, F, C = qn.shape[0], tn.shape[0], qn.shape[1], qc.shape[1]
    bm, splits, _ = topk.k3_plan(nq, nt, torch.cuda.get_device_properties(
        0).multi_processor_count, split)
    kern = lambda: topk.fused_pairwise_topk(qn, qc, tn, tc, cw, wsum, 1000,
                                            k, algorithm, split=split)
    ns = sample or nq
    plain = lambda: topk.plain_pairwise_topk(qn[:ns], qc[:ns], tn, tc, cw,
                                             wsum, 1000, k, algorithm)
    v, i, suspect = kern()
    pv, pi, _ = plain()
    torch.cuda.synchronize()
    n_suspect = int(suspect.sum())
    if n_suspect:
        raise AssertionError(f"K3 [{tag}] flagged {n_suspect} rows")
    err, rows = topk_agree(torch, (v[:ns], i[:ns]), (pv, pi),
                           (qn[:ns], qc[:ns], tn, tc, cw, wsum), algorithm,
                           exact, tag)
    reps = max(2, min(20, int(2e11 // max(nq * nt * max(F, 1), 1))))
    ms = time_ms(kern, reps)
    plain_ms = time_ms(plain, reps)
    device_ms = (kernel_device_ms(kern, min(reps, 5), "topk_kernel")
                 if device_time else None)
    matmul_ms = (time_ms(chunked_matmul(torch, qn, tn), reps)
                 if F and algorithm == "euclidean" else None)
    # per numeric column: an FMA (2 ops) for euclidean; for manhattan an
    # FADD for the difference and an FADD with |.|, two lane instructions
    # at half the 67 TFLOP/s "FMA = 2 ops" rate, so 4 ops
    per_pair = (2 if algorithm == "euclidean" else 4) * F + 2 * C
    bound_ms, bound_by = bound(
        4 * ((nq + nt) * (F + C) + C) + 8 * nq * k, per_pair * nq * nt)
    sample_note = f", plain on the first {ns} rows" if sample else ""
    log(f"K3 [{tag}]: nq={nq} nt={nt} F={F} C={C} k={k} {algorithm}, "
        f"{bm}-row query tiles x {splits} candidate segments: "
        f"max abs err {err}, rows that differ {rows}/{ns}, suspect rows "
        f"{n_suspect}; kernel {ms:.4f} ms (device "
        f"{'n/a' if device_ms is None else f'{device_ms:.4f} ms'}), plain "
        f"{plain_ms:.4f} ms{sample_note}, bound {bound_ms:.4f} ms "
        f"({bound_by}), "
        f"torch.matmul of the cross term alone (partial floor) "
        f"{'n/a' if matmul_ms is None else f'{matmul_ms:.4f} ms'}; "
        f"library: none (no single PyTorch call computes distance + "
        f"exact top-k)")
    del qn, qc, tn, tc, v, i, pv, pi
    torch.cuda.empty_cache()
    return {"name": f"K3 fused_pairwise_topk [{tag}: nq={nq} nt={nt} F={F} "
                    f"C={C} k={k} {algorithm}, S={splits}{sample_note}]",
            "route": "cuda", "source": TOPK_KERNEL[0],
            "replaces": TOPK_KERNEL[1], "kid": kid,
            "launches": 0, "max_abs_err": err, "ms": ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "matmul_ms": matmul_ms,
            "rows_differ": rows, "suspect_rows": n_suspect,
            "bm": bm, "splits": splits}


def merge_plan_note(topk, keys) -> str:
    """The plan a merge launch on ``keys`` [S, nq, k] takes, for the log."""
    S, nq, k = keys.shape
    p = topk.merge_plan(S, nq, k, *topk._merge_device(keys.get_device()))
    return (f"plan: {p.warps} warps a row, {p.rows} rows a block, "
            f"{p.rounds} round(s) of {p.slots} lists, {p.grid} blocks, "
            f"{p.smem} shared bytes")


def run_merge_case(torch, topk, card, nq=KNN_ROWS, kid="K3merge",
                   tag="main path's segments", nt=KNN_ROWS, F=KNN_F, k=KNN_K,
                   in_place=False, floor=None) -> dict:
    """The merge kernel at the segment lists that K3's plan gives ``nq``
    queries against ``nt`` candidates of ``F`` features (default: the kNN
    job's 16,384 x 256, the main path's call at ``nq = 16,384``; a serving
    batch's at nq <= 64), made by the plain version on each segment,
    merged by the kernel and by its plain version (exact: the keys are
    unique); timed beside ``torch.topk`` over the lists laid side by side
    (the library yardstick, without the int32 split).  With ``in_place``
    the keys-out form (``merge_topk_keys``) is held exact writing into list
    0 with each row's k-th value, as a ring hop does, and timed writing
    into a tensor of its own.  ``floor``: the entry of the one-row case
    (``nq = 1`` against 16 candidates: one list), whose times the entry
    carries as its launch floor."""
    qn, qc, tn, tc, cw, wsum = topk_uniform(torch, nq, nt, F, 0, 1)()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, splits, per = topk.k3_plan(nq, nt, sms)
    keys = topk.plain_segment_keys(
        qn, qc, tn, tc, cw, wsum, 1000, k,
        topk.segment_bounds(nt, splits, per))
    del qn, qc, tn, tc
    if in_place:
        want = topk.plain_merge_topk_keys(keys)
        want_kth = (want[:, k - 1] >> 32).to(torch.int32)
        out, kth = torch.empty_like(want), torch.empty(
            nq, dtype=torch.int32, device=keys.device)
        # timed into out: in place, a second call would merge list 0's
        # answer with the lists it came from, whose keys it repeats
        kern = lambda: topk.merge_topk_keys(keys, out, kth)
        plain = lambda: topk.plain_merge_topk_keys(keys)

        def exact():
            inplace, kth0 = keys.clone(), torch.empty_like(kth)
            topk.merge_topk_keys(inplace, inplace[0], kth0)
            kern()
            return (torch.equal(inplace[0], want)
                    and torch.equal(kth0, want_kth)
                    and torch.equal(inplace[1:], keys[1:])
                    and torch.equal(out, want) and torch.equal(kth, want_kth))
        what, out_bytes = "merge_topk_keys", 8 * nq * k + 4 * nq
        form = ", keys and k-th values out, in place into list 0"
    else:
        want = topk.plain_merge_topk(keys)
        kern = lambda: topk.merge_topk_lists(keys)
        plain = lambda: topk.plain_merge_topk(keys)

        def exact():
            return all(torch.equal(g, w) for g, w in zip(kern(), want))
        what, out_bytes = "merge_topk_lists", 8 * nq * k
        form = ""
    if not exact():
        raise AssertionError(f"{what} [{tag}: S={splits} nq={nq} k={k}] "
                             f"differs from its plain version")
    reps = 50 if nq > 64 else 500
    ms = time_ms(kern, reps)
    plain_ms = time_ms(plain, 20)
    flat = keys.permute(1, 0, 2).reshape(nq, -1).contiguous()
    library_ms = time_ms(lambda: torch.topk(
        flat, k, dim=1, largest=False, sorted=True), 20)
    device_ms = kernel_device_ms(kern, 20, "merge_kernel")
    if not exact():             # after the timed calls too
        raise AssertionError(f"{what} [{tag}] changed over repeated calls")
    bound_ms, bound_by = bound(8 * splits * nq * k + out_bytes, 0)
    shape = (f"{tag}: S={splits} nq={nq} k={k}"
             + (f", {nt:,} x {F} candidates" if nt != KNN_ROWS else ""))
    log(f"K3 merge kernel [{shape}{form}]: exact; "
        f"{merge_plan_note(topk, keys)}; kernel {ms:.4f} ms (device "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, torch.topk "
        f"{library_ms:.4f} ms, bound {bound_ms:.7f} ms ({bound_by}) [{card}]")
    del keys, flat
    torch.cuda.empty_cache()
    return {"name": f"K3 {what} [{shape}{form}]",
            "route": "cuda", "source": MERGE_KERNEL[0],
            "replaces": MERGE_KERNEL[1], "kid": kid,
            "launches": 0, "max_abs_err": 0, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "floor_ms": floor and floor["ms"],
            "floor_device_ms": floor and floor["device_ms"]}


# the tiles at which the mesh phase runs K3's keys-out form and its merge:
# the ring's last hop of shard 0 (its carry holds blocks 0..d-2) at the kNN
# cell and at the segmented shape of bench.py:1244, and the last model
# shard's tile of the 2-D fused engine as 2 x 2 and as 1 x 4
RING_D = 4
SEG_NQ, SEG_NT, SEG_F = 2048, 1_050_000, 64     # bench.py:1244
TILE_CASES = (
    # tag, query rows, rows per block, F, blocks, ring hop, seed,
    # K3's kid, the merge's kid
    ("ring hop", KNN_ROWS // RING_D, KNN_ROWS // RING_D, KNN_F, RING_D,
     True, 14, "K3ring", "K3mring"),
    ("segmented ring hop", SEG_NQ // RING_D, SEG_NT // RING_D, SEG_F,
     RING_D, True, 15, "K3ringseg", "K3mringseg"),
    ("2 x 2 model shard", KNN_ROWS // 2, KNN_ROWS // 2, KNN_F, 2, False, 16,
     "K3model22", "K3mmodel22"),
    ("1 x 4 model shard", KNN_ROWS, KNN_ROWS // 4, KNN_F, 4, False, 17,
     "K3model14", "K3mmodel14"),
)


def run_tile_case(torch, topk, card, tag, nq, nt, F, blocks, ring, seed,
                  kid, mkid, floor=None) -> list:
    """K3's keys-out form (``segment_keys``) and the merge at one tile of
    a multi-device engine, each against its plain version on the same
    inputs.  The tile is the last of ``blocks`` candidate blocks of ``nt``
    rows, at index base ``(blocks - 1) * nt``.  On a ring hop list 0 is
    the carry of the blocks before (their plain answer as keys), whose
    k-th values seed K3's bound as the ring seeds it; K3 is held within
    the one-unit contract (the carry merged with its lists against the
    carry merged with the plain version's), and the keys-out merge
    (``merge_topk_keys``) of the carry and K3's lists exactly (keys and
    k-th values, in place too).  On a model shard K3's lists are held
    alone, and ``merge_topk_lists`` over every shard's K3 lists exactly."""
    qn, qc, t_all, tc_all, cw, wsum = topk_uniform(
        torch, nq, blocks * nt, F, 0, seed)()
    base = (blocks - 1) * nt
    tn, tc = t_all[base:], tc_all[base:]
    dev = qn.device
    _, splits, per = topk.device_plan(nq, nt, dev)
    bounds = topk.segment_bounds(nt, splits, per)
    if ring:
        carry = topk.plain_segment_keys(qn, qc, t_all[:base], tc_all[:base],
                                        cw, wsum, 1000, KNN_K, [(0, base)])
        kth0 = (carry[0, :, KNN_K - 1] >> 32).to(torch.int32)
        kth = kth0.clone()
    else:
        others = [topk.segment_keys(qn, qc, t_all[j * nt:(j + 1) * nt],
                                    tc_all[j * nt:(j + 1) * nt], cw, wsum,
                                    1000, KNN_K, base=j * nt)
                  for j in range(blocks - 1)]
        kth = None
    keys = torch.empty((splits, nq, KNN_K), dtype=torch.int64, device=dev)

    def kern():
        if ring:
            kth.copy_(kth0)
        return topk.segment_keys(qn, qc, tn, tc, cw, wsum, 1000, KNN_K,
                                 base=base, out=keys, kth=kth)

    plain = lambda: topk.plain_segment_keys(qn, qc, tn, tc, cw, wsum, 1000,
                                            KNN_K, bounds, base=base)
    kern()
    pkeys = plain()
    torch.cuda.synchronize()
    idx = keys & 0xFFFFFFFF
    if bool(((idx < base) | (idx >= base + nt))[keys != topk._SENT64].any()):
        raise AssertionError(f"K3 [{tag}]: keys carry indices outside the "
                             f"tile's global rows")
    if ring:
        before = [carry]
        ops, origin = (qn, qc, t_all, tc_all, cw, wsum), 0
    else:
        before = []
        ops, origin = (qn, qc, tn, tc, cw, wsum), base
    gv, gi = topk.plain_merge_topk(torch.cat(before + [keys]))
    wv, wi = topk.plain_merge_topk(torch.cat(before + [pkeys]))
    if ring and not bool(((kth <= kth0) & (kth >= gv[:, KNN_K - 1])).all()):
        raise AssertionError(f"K3 [{tag}]: the k-th bound it left is not "
                             f"between the merged k-th value and the seed")
    err, rows = topk_agree(torch, (gv, gi - origin), (wv, wi - origin), ops,
                           "euclidean", False, f"{tag}, keys out")
    ms = time_ms(kern, 20)
    plain_ms = time_ms(plain, 5)
    device_ms = kernel_device_ms(kern, 5, "topk_kernel")
    # the tile's cross term alone, a partial floor (no PyTorch call
    # computes distance + exact top-k)
    matmul_ms = time_ms(chunked_matmul(torch, qn, tn), 20)
    bound_ms, bound_by = bound(
        4 * (nq + nt) * F + 8 * splits * nq * KNN_K, 2 * F * nq * nt)
    seeded = ", seeded k-th bound" if ring else ""
    label = (f"{tag}: nq={nq} nt={nt} F={F} k={KNN_K}, index base {base}, "
             f"S={splits}{seeded}")
    log(f"K3 segment_keys [{label}]: max abs err {err}, rows that differ "
        f"{rows}/{nq}; kernel {ms:.4f} ms (device {device_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, torch.matmul of the cross term alone "
        f"{matmul_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
        f"[{card}]")
    k3_entry = {
        "name": f"K3 segment_keys [{label}, keys out]",
        "route": "cuda", "source": TOPK_KERNEL[0],
        "replaces": TOPK_KERNEL[1], "kid": kid,
        "launches": 0, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "matmul_ms": matmul_ms, "rows_differ": rows,
        "splits": splits}
    del pkeys, t_all, tc_all, tn, tc

    if ring:
        # as the ring runs it: the carry and this hop's K3 lists
        scratch = torch.cat([carry, keys]).contiguous()
        want = topk.plain_merge_topk_keys(scratch)
        want_kth = (want[:, KNN_K - 1] >> 32).to(torch.int32)
        out = torch.empty_like(want)
        mkth = torch.empty(nq, dtype=torch.int32, device=dev)
        mkern = lambda: topk.merge_topk_keys(scratch, out, mkth)
        mplain = lambda: topk.plain_merge_topk_keys(scratch)
        mkern()
        inplace = scratch.clone()
        kth2 = torch.empty_like(mkth)
        topk.merge_topk_keys(inplace, inplace[0], kth2)
        torch.cuda.synchronize()
        if not (torch.equal(out, want) and torch.equal(mkth, want_kth)
                and torch.equal(inplace[0], want)
                and torch.equal(kth2, want_kth)):
            raise AssertionError(f"the keys-out merge [{tag}] differs from "
                                 f"its plain version")
        del inplace
        what, out_bytes = "merge_topk_keys", 8 * nq * KNN_K + 4 * nq
        form = "carry + {} lists, keys and k-th values out"
        replaces = "avenir_tpu/ops/distance.py:130"
    else:
        # every model shard's K3 lists, as the engine merges them
        scratch = torch.cat(others + [keys]).contiguous()
        mkern = lambda: topk.merge_topk_lists(scratch)
        mplain = lambda: topk.plain_merge_topk(scratch)
        got, want = mkern(), mplain()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"the model-axis merge [{tag}] differs "
                                 f"from its plain version")
        del others, got
        what, out_bytes = "merge_topk_lists", 8 * nq * KNN_K
        form = "{} lists of " + f"{blocks} shards"
        replaces = MERGE_KERNEL[1]
    n_lists = scratch.shape[0]
    mms = time_ms(mkern, 50)
    mplain_ms = time_ms(mplain, 20)
    flat = scratch.permute(1, 0, 2).reshape(nq, -1).contiguous()
    mlib_ms = time_ms(lambda: torch.topk(flat, KNN_K, dim=1, largest=False,
                                         sorted=True), 20)
    mdev_ms = kernel_device_ms(mkern, 20, "merge_kernel")
    mbound_ms, mbound_by = bound(8 * n_lists * nq * KNN_K + out_bytes, 0)
    mlabel = (f"{tag}: " + form.format(n_lists - 1 if ring else n_lists)
              + f", nq={nq} k={KNN_K}")
    log(f"K3 {what} [{mlabel}]: exact; {merge_plan_note(topk, scratch)}; "
        f"kernel {mms:.4f} ms (device "
        f"{mdev_ms:.4f} ms), plain {mplain_ms:.4f} ms, torch.topk "
        f"{mlib_ms:.4f} ms, bound {mbound_ms:.4f} ms ({mbound_by}) [{card}]")
    del qn, qc, keys, scratch, flat
    torch.cuda.empty_cache()
    return [k3_entry, {
        "name": f"K3 {what} [{mlabel}]",
        "route": "cuda", "source": MERGE_KERNEL[0], "replaces": replaces,
        "kid": mkid, "launches": 0, "max_abs_err": 0, "ms": mms,
        "device_ms": mdev_ms, "plain_ms": mplain_ms, "bound_ms": mbound_ms,
        "bound_by": mbound_by, "library_ms": mlib_ms,
        "floor_ms": floor and floor["ms"],
        "floor_device_ms": floor and floor["device_ms"]}]


CROSSOVER_NQ = (64, 1024, 4096, KNN_ROWS)
CROSSOVER_NT = (256, 2048, KNN_ROWS, 65536)


def k3_crossover(torch, topk, entries, card) -> None:
    """K3 against the sorted engine's device work (its plain version) at
    the job's width over a grid of query and candidate counts, the
    measurement behind ``ops.topk.k3_applicable``; the grid's entries join
    the kernels line.  The main path's shape is already in ``entries``."""
    main = next(e for e in entries if e["name"].startswith(
        "K3 fused_pairwise_topk [main path"))
    ratio = {(KNN_ROWS, KNN_ROWS): main["plain_ms"] / main["ms"]}
    for nq in CROSSOVER_NQ:
        for nt in CROSSOVER_NT:
            if (nq, nt) in ratio:
                continue
            e = run_topk_case(torch, topk, "engine crossover", "euclidean",
                              KNN_K, False, None,
                              topk_uniform(torch, nq, nt, KNN_F, 0, 8),
                              device_time=False)
            entries.append(e)
            ratio[nq, nt] = e["plain_ms"] / e["ms"]
    rows = "; ".join(
        f"nt={nt}: " + ", ".join(f"nq={nq} {ratio[nq, nt]:.2f}x"
                                 for nq in CROSSOVER_NQ)
        for nt in CROSSOVER_NT)
    agree = sum(topk.k3_applicable("euclidean", KNN_K, KNN_F, 0, "cuda")
                == (r > 1) for r in ratio.values())
    log(f"K3 vs the sorted engine (plain ms / K3 ms, F={KNN_F}, k={KNN_K}; "
        f"above 1: K3 faster): {rows}; the engine gate (ops.topk."
        f"k3_applicable) picks the faster engine at {agree} of "
        f"{len(ratio)} points [{card}]")


# ---------------------------------------------------------------------------
# Naive Bayes paths
# ---------------------------------------------------------------------------

def write_churn_data(gen_telecom_churn) -> tuple:
    """The benchmark's input: 50,000 seeded base rows repeated to 2M; the
    first 1.6M train, the last 400k are scored."""
    train_dir = os.path.join(WORK, "train")
    test_dir = os.path.join(WORK, "test")
    os.makedirs(train_dir)
    os.makedirs(test_dir)
    block = "\n".join(",".join(r) for r in gen_telecom_churn(BASE_ROWS, seed=2)) + "\n"
    reps = TOTAL_ROWS // BASE_ROWS
    n_train = TRAIN_ROWS // BASE_ROWS
    with open(os.path.join(train_dir, "part-00000"), "w") as fh:
        fh.write(block * n_train)
    with open(os.path.join(test_dir, "part-00000"), "w") as fh:
        fh.write(block * (reps - n_train))
    return train_dir, test_dir


def scorer_cost(torch, ds, tables, card: str) -> None:
    """Device time of both scorers over the scored rows, as shipped (XLA's
    float math from ``ops/xla_math.py``: ``exp_f64``, ``log_f32``,
    ``fma_f32``) and with ``torch.exp``, ``torch.log`` and an unfused
    multiply-add in their place (the arithmetic before that module), in
    the same run."""
    import avenir_tpu_torch.models.bayesian as nb
    from avenir_tpu_torch.convert import predictor_tables_to_device

    x = torch.from_numpy(ds.x).cuda()
    values = torch.from_numpy(ds.values).cuda()
    tabs = predictor_tables_to_device(tables, "cuda")
    shipped = (nb.exp_f64, nb.log_f32, nb.fma_f32)
    variants = (("XLA float math", shipped),
                ("torch exp/log", (torch.exp, torch.log,
                                   lambda a, b, c: a * b + c)))
    scorers = (("float64", nb.BayesianPredictor._score_batch),
               ("float32", nb.BayesianPredictor._score_batch_f32))
    ms = {}
    for label, fns in variants:
        nb.exp_f64, nb.log_f32, nb.fma_f32 = fns
        try:
            for prec, fn in scorers:
                ms[label, prec] = time_ms(lambda: fn(x, values, *tabs),
                                          10)
        finally:
            nb.exp_f64, nb.log_f32, nb.fma_f32 = shipped
    for prec, _ in scorers:
        log(f"NB {prec} scorer device time over {x.shape[0]} rows: "
            f"{ms['XLA float math', prec]:.4f} ms with XLA's float math "
            f"(shipped), {ms['torch exp/log', prec]:.4f} ms with torch's "
            f"exp/log [{card}]")


def native_breakdown(torch, train_dir: str, threads: int, card: str
                     ) -> None:
    """Where the cold training time goes at ``ingest.parse.threads`` =
    ``threads``: the native chunk encode alone (host clock), its share of
    one more cold training run on the card under ``torch.profiler``, and
    the device's busy and idle share in that run."""
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import BayesianDistribution

    cfg = dict(NB_CFG, **{"ingest.parse.threads": str(threads)})
    enc = DatasetEncoder(FeatureSchema.from_file(SCHEMA))
    t = time.perf_counter()
    rows = sum(c[3] for c in enc.encode_path_chunks(
        train_dir, ",", chunk_rows=CHUNK_ROWS, parse_threads=threads))
    encode_s = time.perf_counter() - t
    if rows != TRAIN_ROWS:
        raise AssertionError(f"encoder saw {rows} rows, not {TRAIN_ROWS}")
    by_kind, wall_s = profile_device(
        torch, lambda: BayesianDistribution(
            JobConfig(cfg), device="cuda").run(
            train_dir, os.path.join(WORK, f"model_profiled_t{threads}")),
        {"histogram kernel": "histogram_kernel"})
    log(f"NB cold train breakdown, parse threads {threads}: native encode "
        f"alone {encode_s:.3f} s ({TRAIN_ROWS / encode_s:.0f} rows/s), "
        f"encoder share {encode_s / wall_s:.4f} of a {wall_s:.3f} s profiled "
        f"train run [{card}]")
    report_device(by_kind, wall_s, "histogram kernel", card)


def warm_breakdown(torch, train_dir: str, cache_cfg: dict, card: str) -> None:
    """One more warm run off the ingest cache under ``torch.profiler``
    (K2's device time per launch on the main path; its copies: the
    chunks', no widths)."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.models.bayesian import BayesianDistribution

    by_kind, wall_s = profile_device(
        torch, lambda: BayesianDistribution(
            JobConfig(dict(cache_cfg)), device="cuda").run(
            train_dir, os.path.join(WORK, "model_warm_profiled")),
        {"histogram kernel": "histogram_kernel"})
    log(f"warm train breakdown (off the ingest cache, K2): a {wall_s:.3f} s "
        f"profiled run [{card}]")
    report_device(by_kind, wall_s, "histogram kernel", card)


def profile_device(torch, fn, kernels: dict):
    """Run ``fn`` once under ``torch.profiler``; device time by kind
    (``kernels`` maps a kind to a substring of the kernel's name) plus
    host-to-device copies and the rest, and the wall time.  Only
    device-side events count: a CPU op's row repeats the device time of
    the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    by_kind = {kind: [0.0, 0] for kind in kernels}
    by_kind.update({"host-to-device copy": [0.0, 0],
                    "device-to-host copy": [0.0, 0],
                    "other device work": [0.0, 0]})
    others = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if not us or e.device_type == DeviceType.CPU:
            continue
        kind = next((k for k, sub in kernels.items() if sub in e.key), None)
        if kind is None:
            kind = ("host-to-device copy" if "HtoD" in e.key else
                    "device-to-host copy" if "DtoH" in e.key else
                    "other device work")
        if kind == "other device work":
            others.append((us, e.key[:60]))
        by_kind[kind][0] += us
        by_kind[kind][1] += e.count
    if others:
        log("largest other device work: " + "; ".join(
            f"{name} {us / 1e3:.4f} ms" for us, name in sorted(others)[::-1][:3]))
    return by_kind, wall_s


def report_device(by_kind, wall_s, kernel_kind, card) -> None:
    busy_ms = sum(v[0] for v in by_kind.values()) / 1e3
    if busy_ms == 0:
        log("device time: not measured (the profiler saw no device activity)")
        return
    parts = ", ".join(f"{k} {v[0] / 1e3:.4f} ms ({v[1]} events)"
                      for k, v in by_kind.items())
    t, n = by_kind[kernel_kind]
    log(f"device busy {busy_ms:.4f} ms ({parts}; {t / max(n, 1):.2f} us per "
        f"{kernel_kind} launch); device idle share "
        f"{1 - busy_ms / 1e3 / wall_s:.6f} [{card}]")


def nb_paths(torch, histogram, train_dir, test_dir, card) -> dict:
    """NB cold training (K1), then with the ingest cache on, cold and
    warm (K2), then scoring; every output held against the CPU run.
    Returns the main-path launches ``{"K1": n, "K2": n}``."""
    from avenir_tpu_torch import native
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.io import read_lines, split_line
    from avenir_tpu_torch.models.bayesian import (BayesianDistribution,
                                                  BayesianPredictor)

    n_test = TOTAL_ROWS - TRAIN_ROWS
    n_chunks = math.ceil(TRAIN_ROWS / CHUNK_ROWS)
    base_cfg, cache_cfg = NB_CFG, NB_CACHE_CFG

    def train(device, out, cfg=base_cfg):
        t = time.perf_counter()
        counters = BayesianDistribution(JobConfig(dict(cfg)),
                                        device=device).run(train_dir, out)
        return counters, time.perf_counter() - t

    def predictor(model, precision, device, prob_only=False):
        cfg = dict(base_cfg, **{"bayesian.model.file.path": model,
                                "bp.score.precision": precision,
                                "output.feature.prob.only":
                                    str(prob_only).lower()})
        return BayesianPredictor(JobConfig(cfg, "bp"), device=device)

    def score(model, precision, device, out, prob_only=False):
        job = predictor(model, precision, device, prob_only)
        t = time.perf_counter()
        counters = job.run(test_dir, out)
        return counters, time.perf_counter() - t

    def w(name):
        return os.path.join(WORK, name)

    # -- cold training: the native C ingest, then K1 ------------------------
    histogram.reset_launch_counts()
    native.reset_call_counts()
    counters, train_s = train("cuda", w("model_cuda"))
    launches = {"K1": histogram.K1_LAUNCHES}
    log(f"NB cold train launches: K1 {histogram.K1_LAUNCHES}, K2 "
        f"{histogram.K2_LAUNCHES}; native encode calls "
        f"{native.ENCODE_CALLS}; chunks {counters.get('Ingest', 'Chunks')}")
    if (launches["K1"] != n_chunks or histogram.K2_LAUNCHES
            or counters.get("Ingest", "Chunks") != n_chunks):
        raise AssertionError(f"K1 launched {launches['K1']} times on the "
                             f"cold path; expected one per chunk "
                             f"({n_chunks})")
    if native.ENCODE_CALLS != n_chunks:
        raise AssertionError(f"the native encoder ran {native.ENCODE_CALLS} "
                             f"times on the cold path; expected one per "
                             f"chunk ({n_chunks})")

    # -- the ingest cache: a cold run writes it, a warm run replays it: K2
    _, cache_cold_s = train("cuda", w("model_cache_cold"), cache_cfg)
    histogram.reset_launch_counts()
    _, warm_s = train("cuda", w("model_warm"), cache_cfg)
    launches["K2"] = histogram.K2_LAUNCHES
    log(f"NB warm train launches: K1 {histogram.K1_LAUNCHES}, K2 "
        f"{histogram.K2_LAUNCHES}")
    if launches["K2"] != n_chunks or histogram.K1_LAUNCHES:
        raise AssertionError(f"K2 launched {launches['K2']} times on the "
                             f"warm path; expected one per chunk "
                             f"({n_chunks})")
    cold = read_bytes(w("model_cuda"))
    if not cold or read_bytes(w("model_cache_cold")) != cold \
            or read_bytes(w("model_warm")) != cold:
        raise AssertionError("warm or cache-writing model differs from the "
                             "no-cache model")

    # -- scoring on the card ---------------------------------------------
    _, score64_s = score(w("model_cuda"), "float64", "cuda", w("pred64_cuda"))
    _, score32_s = score(w("model_cuda"), "float32", "cuda", w("pred32_cuda"))
    for prec in ("float64", "float32"):
        score(w("model_cuda"), prec, "cuda", w(f"prob{prec}_cuda"), True)

    # -- the same jobs on the CPU; outputs must agree ------------------------
    _, train_cpu_s = train("cpu", w("model_cpu"))
    _, score64_cpu_s = score(w("model_cpu"), "float64", "cpu",
                             w("pred64_cpu"))
    if read_bytes(w("model_cpu")) != cold:
        raise AssertionError("model file differs between cuda and cpu")
    p64 = read_bytes(w("pred64_cuda"))
    if p64 != read_bytes(w("pred64_cpu")):
        raise AssertionError("float64 predictions differ between cuda and cpu")
    if p64.count(b"\n") != n_test:
        raise AssertionError("prediction count is not the scored row count")
    for prec in ("float64", "float32"):
        score(w("model_cpu"), prec, "cpu", w(f"prob{prec}_cpu"), True)
        got = read_bytes(w(f"prob{prec}_cuda"))
        if got != read_bytes(w(f"prob{prec}_cpu")) or \
                got.count(b"\n") != n_test:
            raise AssertionError(f"{prec} prob-only output differs between "
                                 f"cuda and cpu")

    records = [split_line(l) for l in read_lines(test_dir)]
    _, tables, probs64, _, _ = predictor(w("model_cpu"), "float64",
                                         "cpu").score(records)
    ds, _, probs32, _, _ = predictor(w("model_cuda"), "float32",
                                     "cuda").score(records)
    post, prior, gauss_post, gauss_prior, class_prior, is_cont = tables
    lfp, lfpo = BayesianPredictor.log_oracle(ds.x, ds.values, post, prior,
                                             gauss_post, gauss_prior, is_cont)
    viol = BayesianPredictor.f32_score_parity_violations(
        probs64, probs32, lfp, lfpo, class_prior, ln_healthy=math.log(1e-250))
    log(f"float32 (cuda) vs float64 (cpu) parity: {viol}")
    if viol["healthy"] or viol["tail"] or not viol["n_healthy"]:
        raise AssertionError(f"float32 scoring parity contract broken: {viol}")
    scorer_cost(torch, ds, tables, card)

    log(f"NB train (cuda, cold): {TRAIN_ROWS / train_s:.0f} rows/s "
        f"({train_s:.3f} s, {n_chunks} chunks of {CHUNK_ROWS}) [{card}]")
    log(f"NB train (cuda, writing the ingest cache): "
        f"{TRAIN_ROWS / cache_cold_s:.0f} rows/s ({cache_cold_s:.3f} s) "
        f"[{card}]")
    log(f"NB train (cuda, warm off the ingest cache, K2): "
        f"{TRAIN_ROWS / warm_s:.0f} rows/s ({warm_s:.3f} s) [{card}]")
    log(f"NB score float64 (cuda): {n_test / score64_s:.0f} rows/s "
        f"({score64_s:.3f} s) [{card}]")
    log(f"NB score float32 (cuda): {n_test / score32_s:.0f} rows/s "
        f"({score32_s:.3f} s) [{card}]")
    log(f"NB train (cpu): {TRAIN_ROWS / train_cpu_s:.0f} rows/s; score "
        f"float64 (cpu): {n_test / score64_cpu_s:.0f} rows/s")
    log("NB model (cold, cache-writing, warm), float64 predictions and both "
        "prob-only outputs: byte-identical cuda vs cpu")
    warm_breakdown(torch, train_dir, cache_cfg, card)
    return launches


# ---------------------------------------------------------------------------
# NB on the native ingest: parse threads, kill -> resume, quarantine
# ---------------------------------------------------------------------------

BAD_ROWS = 300          # malformed rows in the quarantine phase's input
BAD_CHUNKS = (3, 10)    # the chunks (of the clean input) that hold them


def numpy_encoded_model(train_dir: str) -> bytes:
    """The model of the numpy one-shot encode (``io.read_field_matrix``,
    then ``DatasetEncoder.encode``), counted in one pass on the card: the
    native ingest's plain version at the main path's size."""
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.io import read_field_matrix, write_output
    from avenir_tpu_torch.core.metrics import Counters
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import BayesianDistribution

    ds = DatasetEncoder(FeatureSchema.from_file(SCHEMA)).encode(
        read_field_matrix(train_dir, ","))
    lines = BayesianDistribution(JobConfig(dict(NB_CFG)), device="cuda") \
        .train_lines(ds, ",", Counters())
    out = os.path.join(WORK, "model_numpy")
    write_output(out, lines)
    return read_bytes(out)


def write_dirty_data(train_dir: str) -> str:
    """The training input with ``BAD_ROWS`` malformed rows (short rows and
    unparseable numbers, alternately) spread over two chunks."""
    with open(os.path.join(train_dir, "part-00000")) as fh:
        lines = fh.read().splitlines()
    per = BAD_ROWS // len(BAD_CHUNKS)
    at = {c * CHUNK_ROWS + 17 + i * (CHUNK_ROWS // per)
          for c in BAD_CHUNKS for i in range(per)}
    out = []
    for i, line in enumerate(lines):
        out.append(line)
        if i in at:
            out.append("garbage,row" if i % 2 else
                       line.rsplit(",", 2)[0] + ",noNum,Y")
    dirty_dir = os.path.join(WORK, "dirty")
    os.makedirs(dirty_dir)
    with open(os.path.join(dirty_dir, "part-00000"), "w") as fh:
        fh.write("\n".join(out) + "\n")
    return dirty_dir


def nb_native_paths(torch, histogram, train_dir: str, card: str) -> None:
    """The cold training path's native ingest and resilience layer on the
    card: ``ingest.parse.threads`` 1 and 4 (models, launches, rows/s,
    encoder share, device idle share); kill -> ``--resume`` after an
    ``h2d`` fault (through the CLI) and a prefetch worker death, and
    across devices both ways; a checkpointed run's rate beside the clean
    run's; row quarantine under an error budget, card against CPU.  Every
    model must equal the clean cold model."""
    from avenir_tpu_torch import native
    from avenir_tpu_torch.core import faultinject
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.io import _durability_counters
    from avenir_tpu_torch.models.bayesian import BayesianDistribution

    n_chunks = math.ceil(TRAIN_ROWS / CHUNK_ROWS)
    clean = read_bytes(os.path.join(WORK, "model_cuda"))

    def w(name):
        return os.path.join(WORK, name)

    def train(device, out, cfg, src=train_dir):
        t = time.perf_counter()
        counters = BayesianDistribution(JobConfig(dict(cfg)),
                                        device=device).run(src, out)
        return counters, time.perf_counter() - t

    # -- parse threads 1 and 4 ----------------------------------------------
    if numpy_encoded_model(train_dir) != clean:
        raise AssertionError("the native-encoded model differs from the "
                             "numpy-encoded one")
    for threads in (1, 4):
        cfg = dict(NB_CFG, **{"ingest.parse.threads": str(threads)})
        histogram.reset_launch_counts()
        native.reset_call_counts()
        _, train_s = train("cuda", w(f"model_t{threads}"), cfg)
        k1, calls = histogram.K1_LAUNCHES, native.ENCODE_CALLS
        if k1 != n_chunks or histogram.K2_LAUNCHES or calls != n_chunks:
            raise AssertionError(f"parse threads {threads}: K1 {k1}, native "
                                 f"encode calls {calls}; expected "
                                 f"{n_chunks} each")
        # the clean cold model equals the CPU run's (nb_paths checks it)
        if read_bytes(w(f"model_t{threads}")) != clean:
            raise AssertionError(f"parse threads {threads}: model differs "
                                 f"from the clean cold model")
        log(f"NB cold train, native ingest, parse threads {threads}: "
            f"{TRAIN_ROWS / train_s:.0f} rows/s ({train_s:.3f} s); K1 "
            f"launches {k1}, native encode calls {calls}; model "
            f"byte-identical to the CPU run and to the numpy-encoded model "
            f"[{card}]")
        native_breakdown(torch, train_dir, threads, card)

    # -- checkpointing, kill -> resume ----------------------------------------
    ck_cfg = dict(NB_CFG, **{"checkpoint.interval.chunks": "3"})
    _, clean_s = train("cuda", w("model_clean_again"), NB_CFG)
    _, ck_s = train("cuda", w("model_ckpt"), ck_cfg)
    if read_bytes(w("model_ckpt")) != clean or os.path.exists(
            w("model_ckpt") + ".ckpt"):
        raise AssertionError("the checkpointed run's model differs or its "
                             "sidecar was left")
    log(f"NB cold train with checkpoint.interval.chunks=3: "
        f"{TRAIN_ROWS / ck_s:.0f} rows/s ({ck_s:.3f} s) beside "
        f"{TRAIN_ROWS / clean_s:.0f} rows/s ({clean_s:.3f} s) without "
        f"[{card}]")

    cli_base = ["BayesianDistribution"] + [f"-D{k}={v}"
                                           for k, v in ck_cfg.items()]
    # (plan, the error it must die with, where it dies, where it resumes);
    # the first goes through the command line, the sidecar of the last two
    # crosses devices
    kills = (("h2d@9", faultinject.InjectedFault, "cuda", "cuda"),
             ("worker_death@8", RuntimeError, "cuda", "cuda"),
             ("h2d@9", faultinject.InjectedFault, "cuda", "cpu"),
             ("h2d@9", faultinject.InjectedFault, "cpu", "cuda"))
    for n, (plan, dies_with, kill_on, resume_on) in enumerate(kills):
        out = w(f"model_kill_{n}")
        try:
            if n == 0:
                run_job(cli_base + [f"-Dfault.inject.plan={plan}", train_dir,
                                    out])
            else:
                faultinject.set_injector(faultinject.FaultInjector(
                    faultinject.parse_plan(plan)))
                train(kill_on, out, ck_cfg)
        except dies_with as e:
            died = f"{type(e).__name__}: {e}"
            if dies_with is RuntimeError and "died without" not in died:
                raise
        else:
            raise AssertionError(f"{plan}: the run did not die")
        finally:
            faultinject.set_injector(None)
        if not os.path.exists(out + ".ckpt"):
            raise AssertionError(f"{plan}: the killed run left no sidecar")
        with open(out + ".ckpt", "rb") as fh:
            left = n_chunks - (pickle.load(fh)["chunk_index"] + 1)
        durability = _durability_counters().as_dict().get("Durability", {})
        histogram.reset_launch_counts()
        native.reset_call_counts()
        if n == 0:
            run_job(cli_base + [train_dir, out, "--resume"])
        else:
            train(resume_on, out, dict(ck_cfg, **{"checkpoint.resume":
                                                  "true"}))
        if read_bytes(out) != clean or os.path.exists(out + ".ckpt"):
            raise AssertionError(f"{plan}: the resumed model differs from "
                                 f"the clean run, or the sidecar was left")
        # the run went on from the sidecar: it parsed and folded only the
        # chunks the sidecar did not cover, and refused no generation (a
        # sidecar that failed to load would restart the run from the top
        # and still write the clean model)
        k1 = histogram.K1_LAUNCHES
        calls = native.ENCODE_CALLS
        if (calls != left or k1 != (left if resume_on == "cuda" else 0)
                or _durability_counters().as_dict().get("Durability", {})
                != durability):
            raise AssertionError(
                f"{plan}: resumed on {resume_on} with {calls} native encode "
                f"calls and {k1} K1 launches, the sidecar leaving {left} "
                f"chunks; Durability "
                f"{_durability_counters().as_dict().get('Durability')}")
        log(f"kill -> resume ({plan}, killed on {kill_on} by {died}; "
            f"resumed on {resume_on} from the sidecar, {left} of {n_chunks} "
            f"chunks left: native encode calls {calls}, K1 launches {k1}): "
            f"model byte-identical to the clean run, no sidecar left "
            f"[{card}]")

    # -- row quarantine ----------------------------------------------------
    dirty_dir = write_dirty_data(train_dir)
    q_cfg = dict(NB_CFG, **{"ingest.error.budget": "0.01"})
    sidecars = {}
    for dev in ("cuda", "cpu"):
        out = w(f"model_quarantine_{dev}")
        counters, q_s = train(dev, out, q_cfg, src=dirty_dir)
        if counters.get("Ingest", "Quarantined rows") != BAD_ROWS:
            raise AssertionError(f"{dev}: quarantined "
                                 f"{counters.get('Ingest', 'Quarantined rows')}"
                                 f" rows, not {BAD_ROWS}")
        with open(out + ".quarantine", "rb") as fh:
            sidecars[dev] = fh.read()
        if dev == "cuda":
            log(f"NB cold train with {BAD_ROWS} malformed rows quarantined: "
                f"{TRAIN_ROWS / q_s:.0f} rows/s ({q_s:.3f} s) [{card}]")
    if (read_bytes(w("model_quarantine_cuda"))
            != read_bytes(w("model_quarantine_cpu"))
            or sidecars["cuda"] != sidecars["cpu"]):
        raise AssertionError("quarantine: model or sidecar differs between "
                             "cuda and cpu")
    if read_bytes(w("model_quarantine_cuda")) != clean:
        raise AssertionError("quarantine: the model differs from the clean "
                             "input's")
    log(f"row quarantine (ingest.error.budget=0.01, {BAD_ROWS} bad rows): "
        f"model and .quarantine sidecar byte-identical cuda vs cpu, model "
        f"equal to the clean input's [{card}]")


# ---------------------------------------------------------------------------
# kNN paths
# ---------------------------------------------------------------------------

def write_knn_data():
    """16,384 training and 16,384 test rows of 256 features in [0, 1)
    (three decimals, from a seed), a class planted in the first eight
    features, and the schema and job properties.  Returns the input
    directory, the job properties and the float32 feature matrix."""
    import numpy as np

    d = os.path.join(WORK, "knn")
    inp = os.path.join(d, "inp")
    os.makedirs(inp)
    rng = np.random.default_rng(11)
    ints = rng.integers(0, 1000, (2 * KNN_ROWS, KNN_F))
    cls = np.where(ints[:, :8].mean(axis=1) >= 500, "B", "A")
    lut = np.asarray([f"{i / 1000:.3f}" for i in range(1000)])
    text = lut[ints]
    lines = [f"K{i}," + ",".join(text[i]) + f",{cls[i]}"
             for i in range(2 * KNN_ROWS)]
    for name, part in (("tr-00000", lines[:KNN_ROWS]),
                       ("te-00000", lines[KNN_ROWS:])):
        with open(os.path.join(inp, name), "w") as fh:
            fh.write("\n".join(part) + "\n")
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    fields += [{"name": f"f{j}", "ordinal": j + 1, "dataType": "double",
                "feature": True, "min": 0, "max": 1} for j in range(KNN_F)]
    fields.append({"name": "cls", "ordinal": KNN_F + 1,
                   "dataType": "categorical", "cardinality": ["A", "B"]})
    schema = os.path.join(d, "knn_schema.json")
    with open(schema, "w") as fh:
        json.dump({"fields": fields}, fh)
    sim = os.path.join(d, "sim.properties")
    with open(sim, "w") as fh:
        fh.write(f"feature.schema.file.path={schema}\n"
                 f"base.set.split.prefix=tr\n"
                 f"output.top.matches={KNN_K}\n")
    vote = os.path.join(d, "knn.properties")
    with open(vote, "w") as fh:
        fh.write(f"feature.schema.file.path={schema}\n"
                 f"top.match.count={KNN_K}\nvalidation.mode=true\n"
                 f"kernel.function=none\n")
    return d, inp, sim, vote, (ints / 1000).astype(np.float32)


def pair_rows(path):
    """Pair lines grouped by test id, in file order."""
    rows = {}
    for line in read_bytes(path).decode().splitlines():
        f = line.split(",")
        rows.setdefault(f[1], []).append(f)
    return rows


def compare_pairs(torch, cuda_out, cpu_out, feats, label) -> set:
    """The pair files of the card and the CPU: equal, or per test row the
    same neighbors up to the reference's one-unit rounding contract
    (values within one unit, each index set carrying float64-oracle
    distances within one unit of the oracle's own k smallest).  Returns the
    test ids whose lines differ."""
    a, b = pair_rows(cuda_out), pair_rows(cpu_out)
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: test rows differ")
    differ = {t for t in a if a[t] != b[t]}
    if len(differ) > max(1, len(a) // 100):
        raise AssertionError(f"{label}: {len(differ)} of {len(a)} test rows "
                             f"differ")
    t_all = torch.from_numpy(feats[:KNN_ROWS]).cuda().double()
    for tid in differ:
        ra, rb = a[tid], b[tid]
        if len(ra) != len(rb) or any(
                abs(int(x[2]) - int(y[2])) > 1 for x, y in zip(ra, rb)):
            raise AssertionError(f"{label}: test row {tid} differs by more "
                                 f"than one unit")
        qi = int(tid[1:])                  # test rows follow the training
        q = torch.from_numpy(feats[qi:qi + 1]).cuda().double()
        d = ((torch.cdist(q, t_all, compute_mode=EXACT_CDIST)[0] ** 2
              / KNN_F).sqrt() * 1000).floor().long()
        best = torch.sort(d).values[:len(ra)]
        for rows in (ra, rb):
            idx = torch.tensor([int(r[0][1:]) for r in rows], device="cuda")
            if int((torch.sort(d[idx]).values - best).abs().max()) > 1:
                raise AssertionError(f"{label}: test row {tid} carries "
                                     f"wrong oracle distances")
    return differ


def knn_paths(torch, topk, card) -> tuple:
    """The kNN job at full width through the port's command line, on the
    card and on the CPU, then top-16 voting; then the knn_classify
    runbook.  Returns the main-path launches ``{"K3": n, "K3merge": n}``
    and the job's data (for the serving phase)."""
    d, inp, sim, vote, feats = write_knn_data()

    def job(name, conf, src, out, device):
        t = time.perf_counter()
        text = run_job([name, f"-Dconf.path={conf}", src, out,
                        "--device", device])
        return text, time.perf_counter() - t

    topk.reset_launch_counts()
    text, dist_s = job("SameTypeSimilarity", sim, inp,
                       os.path.join(d, "simi_cuda"), "cuda")
    launches = {"K3": topk.K3_LAUNCHES, "K3merge": topk.MERGE_LAUNCHES}
    fused = counter(text, "Distance", "Fused engine calls")
    reresolved = counter(text, "Distance", "Re-resolved rows")
    log(f"kNN distance job launches: K3 {launches['K3']}, merge "
        f"{launches['K3merge']}; fused engine calls {fused}; suspect rows "
        f"re-resolved by the sorted engine {reresolved}")
    if launches["K3"] < 1 or launches["K3"] != fused:
        raise AssertionError(f"K3 launched {launches['K3']} times for "
                             f"{fused} fused-engine calls")
    if launches["K3merge"] < 1:
        raise AssertionError("the kNN job's K3 call merged no segments")
    text_cpu, dist_cpu_s = job("SameTypeSimilarity", sim, inp,
                               os.path.join(d, "simi_cpu"), "cpu")
    if counter(text_cpu, "Basic", "Pairs emitted") != KNN_ROWS * KNN_K:
        raise AssertionError("the distance job emitted the wrong pair count")
    differ = compare_pairs(torch, os.path.join(d, "simi_cuda"),
                           os.path.join(d, "simi_cpu"), feats, "pair files")
    log(f"kNN pair files cuda vs cpu: {len(differ)} of {KNN_ROWS} test rows "
        f"differ, each within the one-unit oracle-confirmed contract")

    _, vote_s = job("NearestNeighbor", vote, os.path.join(d, "simi_cuda"),
                    os.path.join(d, "pred_cuda"), "cuda")
    job("NearestNeighbor", vote, os.path.join(d, "simi_cpu"),
        os.path.join(d, "pred_cpu"), "cpu")
    pa = read_bytes(os.path.join(d, "pred_cuda")).decode().splitlines()
    pb = read_bytes(os.path.join(d, "pred_cpu")).decode().splitlines()
    bad = [x for x, y in zip(pa, pb) if x != y
           and x.split(",")[0] not in differ]
    if len(pa) != KNN_ROWS or len(pb) != KNN_ROWS or bad:
        raise AssertionError(f"kNN predictions differ outside the rows "
                             f"whose pair lines differed: {bad[:3]}")
    n_pred_diff = sum(x != y for x, y in zip(pa, pb))
    log(f"kNN predictions cuda vs cpu: byte-identical except "
        f"{n_pred_diff} rows, all among the {len(differ)} rows whose pair "
        f"lines differed")
    log(f"kNN distance job (cuda): {2 * KNN_ROWS / dist_s:.0f} rows/s "
        f"({dist_s:.3f} s for {KNN_ROWS} + {KNN_ROWS} rows, F={KNN_F}, "
        f"top {KNN_K}) [{card}]; (cpu): {2 * KNN_ROWS / dist_cpu_s:.0f} "
        f"rows/s")
    log(f"kNN voting job (cuda): {KNN_ROWS / vote_s:.0f} test rows/s "
        f"({vote_s:.3f} s) [{card}]")

    knn_breakdown(torch, inp, sim, d, card)
    knn_runbook(card)
    return launches, (d, inp, sim, vote, feats)


def knn_breakdown(torch, inp, sim, d, card) -> None:
    """Where the distance job's time goes: the host parse and encode
    alone (host clock), then one more run on the card under
    ``torch.profiler``: K3, copies, the rest, and the device idle share."""
    from avenir_tpu_torch.core.config import load_job_config
    from avenir_tpu_torch.core.io import _input_files, read_lines, split_line
    from avenir_tpu_torch.models.knn import SameTypeSimilarity

    job = SameTypeSimilarity(load_job_config({"conf.path": sim}),
                             device="cuda")
    t = time.perf_counter()
    recs = {"tr": [], "te": []}
    for fp in _input_files(inp):
        recs[os.path.basename(fp)[:2]] += [split_line(l)
                                           for l in read_lines(fp)]
    vocabs = {}
    job._encode(recs["tr"], vocabs)
    job._encode(recs["te"], vocabs)
    encode_s = time.perf_counter() - t
    by_kind, wall_s = profile_device(
        torch, lambda: run_job(["SameTypeSimilarity", f"-Dconf.path={sim}",
                                inp, os.path.join(d, "simi_profiled"),
                                "--device", "cuda"]),
        {"K3 kernel": "topk_kernel", "K3 layout prologue": "layout_kernel",
         "K3 merge kernel": "merge_kernel"})
    log(f"kNN distance job breakdown: host parse + encode alone "
        f"{encode_s:.3f} s of a {wall_s:.3f} s profiled run [{card}]")
    report_device(by_kind, wall_s, "K3 kernel", card)


def knn_runbook(card) -> None:
    """resource/knn_classify/run.sh at its 120-row size, on the card and on
    the CPU: every output byte-identical."""
    from avenir_tpu_torch.datagen import gen_blobs

    outs = ("simi", "pred", "nbmodel", "probs", "join", "predw")
    rows = [",".join(r) for r in gen_blobs(120, seed=41)]
    cwd = os.getcwd()
    os.chdir(KNN_RUNBOOK)        # its properties name blobs.json relatively
    try:
        for dev in ("cuda", "cpu"):
            w = os.path.join(WORK, f"knn_runbook_{dev}")
            for sub in ("inp", "train", "pprob"):
                os.makedirs(os.path.join(w, sub))
            with open(os.path.join(w, "inp", "tr-00000"), "w") as fh:
                fh.write("\n".join(rows[:100]) + "\n")
            with open(os.path.join(w, "inp", "te-00000"), "w") as fh:
                fh.write("\n".join(rows[-20:]) + "\n")
            shutil.copy(os.path.join(w, "inp", "tr-00000"),
                        os.path.join(w, "train", "part-00000"))
            dv = ["--device", dev]
            run_job(["SameTypeSimilarity", "-Dconf.path=sim.properties",
                     f"{w}/inp", f"{w}/simi"] + dv)
            run_job(["NearestNeighbor", "-Dconf.path=knn.properties",
                     f"{w}/simi", f"{w}/pred"] + dv)
            run_job(["BayesianDistribution", "-Dconf.path=nb.properties",
                     f"{w}/train", f"{w}/nbmodel"] + dv)
            run_job(["BayesianPredictor", "-Dconf.path=nbprob.properties",
                     f"-Dbayesian.model.file.path={w}/nbmodel",
                     f"{w}/train", f"{w}/probs"] + dv)
            shutil.copy(f"{w}/probs/part-r-00000",
                        f"{w}/pprob/prDistr-r-00000")
            run_job(["FeatureCondProbJoiner", "-Dconf.path=join.properties",
                     f"{w}/simi,{w}/pprob", f"{w}/join"] + dv)
            run_job(["NearestNeighbor", "-Dconf.path=knnw.properties",
                     f"{w}/join", f"{w}/predw"] + dv)
    finally:
        os.chdir(cwd)
    for out in outs:
        a = read_bytes(os.path.join(WORK, "knn_runbook_cuda", out))
        if not a or a != read_bytes(os.path.join(WORK, "knn_runbook_cpu",
                                                 out)):
            raise AssertionError(f"knn_classify runbook: {out} differs "
                                 f"between cuda and cpu")
    log(f"knn_classify runbook (120 rows): {', '.join(outs)} byte-identical "
        f"cuda vs cpu [{card}]")


# ---------------------------------------------------------------------------
# serving: the NB server through the CLI, the kNN server in process
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the device mesh: the ring, the 2-D engines, the sharded count
# ---------------------------------------------------------------------------

SORT_SAMPLE = 2048


def hold_to_one_device(torch, got, want, ops, label) -> int:
    """A mesh engine's host answer against the one-device K3 answer:
    expected equal (K3 never splits the feature axis, so a pair's value
    does not depend on the tile it is in); rows that differ are reported
    and held to the one-unit oracle-confirmed contract.  Returns their
    count."""
    import numpy as np
    (gv, gi), (wv, wi) = got, want
    rows = np.flatnonzero((gv != wv).any(1) | (gi != wi).any(1))
    if rows.size:
        log(f"{label}: {rows.size} rows differ from the one-device K3 "
            f"answer ({rows[:8].tolist()}...), held to the one-unit "
            f"contract")
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        qn, qc, tn, tc, nw, cw = ops
        topk_agree(torch, (t(gv), t(gi)), (t(wv), t(wi)),
                   (t(qn), t(qc), t(tn), t(tc),
                    t(np.asarray(cw, np.float32)), float(nw.sum() + cw.sum())),
                   "euclidean", False, label)
    return int(rows.size)


def ring_sort_check(torch, got, ops, plain) -> int:
    """The ring's ``sort`` selection against the plain engine's answer:
    values within one unit (rows whose values differ under 1%), and at
    every row the indices carry float64-oracle distances within one unit
    of the oracle's own k smallest (its tie indices follow ring arrival
    order, not the lowest index).  Returns the rows whose values differ."""
    import numpy as np
    (gv, gi), (pv, _) = got, plain
    err = int(np.abs(gv.astype(np.int64) - pv).max())
    differ = int(((gv != pv).any(1)).sum())
    if err > 1 or differ > max(1, len(gv) // 100):
        raise AssertionError(f"ring sort: max abs err {err}, {differ} rows "
                             f"differ from the plain engine")
    qn, _, tn, _, _, _ = ops
    t_all = torch.from_numpy(tn).cuda().double()
    idx = torch.from_numpy(gi).cuda().long()
    for lo in range(0, len(gv), 512):
        q = torch.from_numpy(qn[lo:lo + 512]).cuda().double()
        d = ((torch.cdist(q, t_all, compute_mode=EXACT_CDIST) ** 2
              / KNN_F).sqrt() * 1000).floor().long()
        best = torch.topk(d, KNN_K, dim=1, largest=False).values
        at = torch.sort(torch.gather(d, 1, idx[lo:lo + 512]), dim=1).values
        if int((at - torch.sort(best, dim=1).values).abs().max()) > 1:
            raise AssertionError("ring sort: indices carry wrong oracle "
                                 "distances")
    return differ


def profile_kernels(torch, fn, kinds, windows=8):
    """``profile_device`` over ``fn``, again (up to ``windows`` times)
    while the profiler kept no K3 event: on the card's machine it can drop
    a window's kernel events.  Returns ``(by_kind, wall_s, per_launch)``,
    ``per_launch`` mapping each kind to its mean ms a launch, or None
    where no event was kept (not measured)."""
    for _ in range(windows):
        by_kind, wall_s = profile_device(torch, fn, kinds)
        if by_kind["K3 kernel"][1]:
            break
    per_launch = {kind: (us / n / 1e3 if n else None)
                  for kind, (us, n) in by_kind.items()}
    return by_kind, wall_s, per_launch


def ms_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def mesh_paths(torch, topk, histogram, knn_data, train_dir, card) -> dict:
    """The multi-device engines on meshes that name cuda:0 more than once
    (every hop and launch of a four-device program, no bytes between
    cards): the ring at the kNN cell (16,384 x 16,384 x 256, k = 16) on
    [cuda:0] and [cuda:0] * 4, its ``sort`` selection on 2,048 queries,
    the ring at the segmented shape of bench.py:1244 (2,048 x 1,050,000 x
    64), the 2-D fused engine as 2 x 2 and 1 x 4, the distance job on a
    2 x 2 mesh (the one-device job's bytes) and the NB count over 4
    shards.  Returns the launches of the 4-way rings and of the 2-D fused
    engines, by the kid of their tile's entries (TILE_CASES)."""
    import numpy as np
    from avenir_tpu_torch.core.config import load_job_config
    from avenir_tpu_torch.models.bayesian import _nb_local
    from avenir_tpu_torch.models.knn import SameTypeSimilarity
    from avenir_tpu_torch.ops import counting
    from avenir_tpu_torch.ops.distance import (pairwise_distances,
                                               pairwise_topk_ring)
    from avenir_tpu_torch.parallel import make_mesh

    cuda = torch.device("cuda", 0)
    d, inp, sim, vote, feats = knn_data
    empty = np.zeros((KNN_ROWS, 0), np.int32)
    ops = (feats[KNN_ROWS:], empty, feats[:KNN_ROWS], empty, np.ones(KNN_F),
           np.zeros(0))
    one = pairwise_distances(*ops, top_k=KNN_K, device=cuda)
    one_ms = time_ms(lambda: pairwise_distances(*ops, top_k=KNN_K,
                                                device=cuda), 3)
    bound_ms, bound_by = bound(4 * 2 * KNN_ROWS * KNN_F,
                               2 * KNN_F * KNN_ROWS * KNN_ROWS)
    launches = {}
    kinds = {"K3 kernel": "topk_kernel", "K3m merge kernel": "merge_kernel",
             "K3 layout prologue": "layout_kernel"}
    for n in (1, RING_D):
        mesh = make_mesh([cuda] * n)
        ring = lambda: pairwise_topk_ring(*ops, KNN_K, mesh=mesh,
                                          stats=stats)
        stats = {}
        topk.reset_launch_counts()
        got = ring()
        k3, km = topk.K3_LAUNCHES, topk.MERGE_LAUNCHES
        if stats != {"selection": "bins", "reresolved": 0}:
            raise AssertionError(f"ring on {mesh}: {stats}")
        if k3 != n * n or km != n * n:
            raise AssertionError(f"ring on {mesh}: {k3} K3 and {km} merge "
                                 f"launches, expected {n * n} each")
        differ = hold_to_one_device(torch, got, one, ops, f"ring {mesh}")
        ring_ms = time_ms(ring, 3)
        by_kind, wall_s, per = profile_kernels(torch, ring, kinds)
        log(f"ring [{mesh}, bins, nq=nt={KNN_ROWS} F={KNN_F} k={KNN_K}]: "
            f"{k3} K3 + {km} merge launches, {differ} rows differ from the "
            f"one-device K3; call {ring_ms:.4f} ms (host arrays in and "
            f"out) against the one-device engine's {one_ms:.4f} ms; per "
            f"hop K3 {ms_or_not(per['K3 kernel'])}, merge "
            f"{ms_or_not(per['K3m merge kernel'])} of device time; ops "
            f"bound of the whole {bound_ms:.4f} ms ({bound_by}) [{card}]")
        report_device(by_kind, wall_s, "K3 kernel", card)
        if n == RING_D:
            launches.update(K3ring=k3, K3mring=km)

    # the sort selection on a sample of the queries
    mesh4 = make_mesh([cuda] * RING_D)
    sample = tuple(a[:SORT_SAMPLE] if j < 2 else a for j, a in
                   enumerate(ops))
    stats = {}
    got = pairwise_topk_ring(*sample, KNN_K, mesh=mesh4, selection="sort",
                             stats=stats)
    plain = pairwise_distances(*sample, top_k=KNN_K, device=cuda,
                               topk_method="sorted")
    differ = ring_sort_check(torch, got, sample, plain)
    sort_ms = time_ms(lambda: pairwise_topk_ring(
        *sample, KNN_K, mesh=mesh4, selection="sort"), 3)
    log(f"ring [{mesh4}, sort, {SORT_SAMPLE} queries]: {differ} rows' "
        f"values differ from the plain engine, within one unit; every "
        f"index set oracle-confirmed; call {sort_ms:.4f} ms [{card}]")

    # the 2-D fused engine
    for data, model, want_k3, want_m, kid in ((2, 2, 4, 2, "model22"),
                                              (1, 4, 4, 1, "model14")):
        mesh = make_mesh([cuda] * 4, data=data, model=model)
        stats = {}
        call = lambda: pairwise_distances(*ops, top_k=KNN_K, mesh=mesh,
                                          stats=stats)
        topk.reset_launch_counts()
        got = call()
        k3, km = topk.K3_LAUNCHES, topk.MERGE_LAUNCHES
        if stats["engine"] != "fused" or (k3, km) != (want_k3, want_m):
            raise AssertionError(f"2-D engine on {mesh}: {stats}, {k3} K3 "
                                 f"and {km} merge launches")
        launches.update({f"K3{kid}": k3, f"K3m{kid}": km})
        differ = hold_to_one_device(torch, got, one, ops, f"2-D {mesh}")
        ms = time_ms(call, 3)
        # the plain version: the 2-D sorted engine on the same mesh
        plain_ms = time_ms(lambda: pairwise_distances(
            *ops, top_k=KNN_K, mesh=mesh, topk_method="sorted"), 2)
        by_kind, wall_s, per = profile_kernels(torch, call, kinds)
        log(f"2-D fused engine [{mesh}, nq=nt={KNN_ROWS} F={KNN_F}]: {k3} "
            f"K3 + {km} merge launches, {differ} rows differ from the "
            f"one-device K3; call {ms:.4f} ms against {one_ms:.4f} ms (the "
            f"2-D sorted engine {plain_ms:.4f} ms); per launch K3 "
            f"{ms_or_not(per['K3 kernel'])}, merge "
            f"{ms_or_not(per['K3m merge kernel'])} of device time [{card}]")
        report_device(by_kind, wall_s, "K3 kernel", card)

    # the distance job on a 2 x 2 mesh: the one-device job's bytes
    mesh22 = make_mesh([cuda] * 4, data=2, model=2)
    out = os.path.join(d, "simi_mesh")
    SameTypeSimilarity(load_job_config({"conf.path": sim}),
                       device="cuda").run(inp, out, mesh=mesh22)
    if read_bytes(out) != read_bytes(os.path.join(d, "simi_cuda")):
        raise AssertionError("the distance job on a 2 x 2 mesh wrote other "
                             "bytes than on one device")
    log(f"distance job on {mesh22}: the one-device job's bytes")

    # the ring at the segmented shape, where it matters: 270 MB of
    # candidates, each shard holding a quarter
    rng = np.random.default_rng(7)
    seg = (rng.random((SEG_NQ, SEG_F), dtype=np.float32),
           np.zeros((SEG_NQ, 0), np.int32),
           rng.random((SEG_NT, SEG_F), dtype=np.float32),
           np.zeros((SEG_NT, 0), np.int32), np.ones(SEG_F), np.zeros(0))
    seg_one = pairwise_distances(*seg, top_k=KNN_K, device=cuda)
    topk.reset_launch_counts()
    got = pairwise_topk_ring(*seg, KNN_K, mesh=mesh4)
    k3, km = topk.K3_LAUNCHES, topk.MERGE_LAUNCHES
    if k3 != RING_D ** 2 or km != RING_D ** 2:
        raise AssertionError(f"segmented ring: {k3} K3 and {km} merge "
                             f"launches")
    launches.update(K3ringseg=k3, K3mringseg=km)
    differ = hold_to_one_device(torch, got, seg_one, seg, "segmented ring")
    seg_ms = time_ms(lambda: pairwise_topk_ring(*seg, KNN_K, mesh=mesh4), 2)
    seg_one_ms = time_ms(lambda: pairwise_distances(*seg, top_k=KNN_K,
                                                    device=cuda), 2)
    by_kind, wall_s, per = profile_kernels(
        torch, lambda: pairwise_topk_ring(*seg, KNN_K, mesh=mesh4), kinds)
    sb_ms, sb_by = bound(4 * (SEG_NQ + SEG_NT) * SEG_F,
                         2 * SEG_F * SEG_NQ * SEG_NT)
    log(f"ring [{mesh4}, bins, {SEG_NQ} x {SEG_NT} F={SEG_F} k={KNN_K}]: "
        f"{k3} K3 + {km} merge launches, {differ} rows differ from the "
        f"one-device K3; call {seg_ms:.4f} ms against the one-device "
        f"engine's {seg_one_ms:.4f} ms (host arrays in and out); per hop "
        f"K3 {ms_or_not(per['K3 kernel'])}, merge "
        f"{ms_or_not(per['K3m merge kernel'])} of device time; ops bound "
        f"{sb_ms:.4f} ms ({sb_by}) [{card}]")
    report_device(by_kind, wall_s, "K3 kernel", card)
    del seg

    # the NB count over four shards of the main path's first chunk
    xs, ys, C, B, _ = main_path_chunk(train_dir)
    want = counting.sharded_reduce(_nb_local, xs, ys, device=cuda,
                                   static_args=(C, B))
    histogram.reset_launch_counts()
    got = counting.sharded_reduce(_nb_local, xs, ys, mesh=mesh4,
                                  static_args=(C, B))
    n_k1 = histogram.K1_LAUNCHES
    if not torch.equal(got, want) or n_k1 != RING_D:
        raise AssertionError(f"sharded count on {mesh4}: equal "
                             f"{torch.equal(got, want)}, {n_k1} K1 launches")
    log(f"NB count over {mesh4} ({len(xs)} rows of the first chunk): the "
        f"one-shard table, {n_k1} K1 launches")
    return launches


SERVE_RUNBOOK = os.path.join(ROOT, "resource", "serving")
SERVE_BATCH_SIZES = (1, 2, 3, 5, 8, 13, 16, 33, 64)
SERVE_CLIENTS = 16
K3_SERVING_NQ = (1, 8, 64)
KNN_SERVE_QUERIES = 512
PROFILED_REQUESTS = 128


def request(port, obj, timeout=60.0):
    from avenir_tpu_torch.serve.server import request as serve_request
    return serve_request("127.0.0.1", port, obj, timeout=timeout)


def merged_counter(stats, model, name):
    return int(stats["models"][model]["counters"].get("Serve", {})
               .get(name, 0))


def quantiles_ms(samples):
    xs = sorted(samples)
    return (xs[len(xs) // 2] * 1e3,
            xs[min(len(xs) - 1, int(len(xs) * 0.99))] * 1e3)


def fan_out(fn, items, clients=SERVE_CLIENTS):
    """``fn(item)`` for every item from ``clients`` threads; returns the
    results in item order and each call's host-clock latency."""
    import threading

    out, lat = [None] * len(items), [0.0] * len(items)
    errors = []

    def client(c):
        try:
            for i in range(c, len(items), clients):
                t = time.perf_counter()
                out[i] = fn(items[i])
                lat[i] = time.perf_counter() - t
        except BaseException as e:        # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, lat


def check_replicas_on(torch, srv, model, want: str) -> int:
    """Every replica of every variant of ``model`` on ``want``, with each
    of its adapter's device tensors there too; returns the replica
    count."""
    n = 0
    for group in srv.pool.variant_groups(model):
        for rep in group.replicas:
            tensors = rep.entry.adapter.tensors()
            if str(rep.device) != want or not tensors or any(
                    str(t.device) != want for t in tensors):
                raise AssertionError(
                    f"{model} replica {group.variant}/{rep.index} on "
                    f"{rep.device}, tensors on "
                    f"{sorted({str(t.device) for t in tensors})}, not {want}")
            n += 1
    return n


def serve_nb(torch, card) -> None:
    """resource/serving/run.sh on the card: train the churn artifact,
    start ``python -m avenir_tpu_torch serve`` with the runbook's
    serve.properties on an ephemeral port, send the 600 test rows from 16
    concurrent single-row clients and batch requests of 1 to 64 rows
    under both variants, and hold every response to the port's batch
    ``BayesianPredictor`` line on the card, byte for byte; no scorer may
    be built after warmup; SIGINT drains the server, which writes its
    ``--trace``.  Then part of the same traffic against an in-process
    server under ``torch.profiler`` for the device's busy time."""
    import signal
    import re

    from avenir_tpu_torch.datagen import gen_telecom_churn

    w = os.path.join(WORK, "serve_nb")
    os.makedirs(os.path.join(w, "train"))
    os.makedirs(os.path.join(w, "test"))
    rows = [",".join(r) for r in gen_telecom_churn(3000, seed=29)]
    with open(os.path.join(w, "train", "part-00000"), "w") as fh:
        fh.write("\n".join(rows[:2400]) + "\n")
    test = rows[2400:]
    with open(os.path.join(w, "test", "part-00000"), "w") as fh:
        fh.write("\n".join(test) + "\n")
    schema = os.path.join(SERVE_RUNBOOK, "teleComChurn.json")
    model = os.path.join(w, "model")
    run_job(["BayesianDistribution",
             f"-Dconf.path={os.path.join(SERVE_RUNBOOK, 'nb.properties')}",
             f"-Dfeature.schema.file.path={schema}",
             os.path.join(w, "train"), model, "--device", "cuda"])
    bp = os.path.join(w, "bp.properties")
    with open(bp, "w") as fh:
        fh.write(f"feature.schema.file.path={schema}\n"
                 f"bayesian.model.file.path={model}\n")
    batch = {}
    for variant, precision in (("f32", "float32"), ("f64", "float64")):
        out = os.path.join(w, f"pred_{variant}")
        run_job(["BayesianPredictor", f"-Dconf.path={bp}",
                 f"-Dbp.score.precision={precision}",
                 os.path.join(w, "test"), out, "--device", "cuda"])
        batch[variant] = read_bytes(out).decode().splitlines()

    trace = os.path.join(w, "serve_trace.json")
    log_path = os.path.join(w, "server.log")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t_start = time.perf_counter()
    with open(log_path, "w") as log_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch", "serve",
             f"-Dconf.path={os.path.join(SERVE_RUNBOOK, 'serve.properties')}",
             f"-Dserve.model.churn.conf={bp}", "-Dserve.port=0",
             "--trace", trace], cwd=w, env=env, stdout=log_fh,
            stderr=subprocess.STDOUT)
    try:
        port = None
        while port is None:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}: "
                                     + open(log_path).read()[-2000:])
            if time.perf_counter() - t_start > 180:
                raise AssertionError("serve did not come up in 180 s")
            m = re.search(r"serving .* on ([\w.]+):(\d+)",
                          open(log_path).read())
            port = int(m.group(2)) if m else None
            time.sleep(0.1)
        up_s = time.perf_counter() - t_start
        stats0 = request(port, {"cmd": "stats"})
        churn = stats0["models"]["churn"]
        devices = [r["device"] for v in churn["variants"].values()
                   for r in v["replicas"]]
        if devices != ["cuda:0"] * 4:
            raise AssertionError(f"serve replicas on {devices}, not 2 x 2 "
                                 f"on cuda:0")
        builds0 = merged_counter(stats0, "churn", "Scorer compilations")
        hits0 = merged_counter(stats0, "churn", "Scorer cache hits")
        if builds0 != 2 * 2 * 7:
            raise AssertionError(f"warmup built {builds0} scorers, not 28")

        # 16 concurrent single-row clients, every test row under each
        # variant
        items = [(v, i) for v in ("f32", "f64") for i in range(len(test))]
        t = time.perf_counter()
        outs, lat = fan_out(lambda it: request(port, {
            "model": "churn", "row": test[it[1]], "variant": it[0]}), items)
        single_s = time.perf_counter() - t
        bad = [(v, i, o) for (v, i), o in zip(items, outs)
               if o.get("output") != batch[v][i] or o.get("variant") != v]
        if bad:
            raise AssertionError(f"{len(bad)} single-row responses differ "
                                 f"from the batch predictor, e.g. {bad[0]}")
        # batch requests of 1 to 64 rows under each variant
        n_rows, t = 0, time.perf_counter()
        for v in ("f32", "f64"):
            lo = 0
            for size in SERVE_BATCH_SIZES:
                resp = request(port, {"model": "churn", "variant": v,
                                      "rows": test[lo:lo + size]})
                if resp.get("outputs") != batch[v][lo:lo + size]:
                    raise AssertionError(f"a {size}-row {v} response "
                                         f"differs from the batch lines")
                lo, n_rows = lo + size, n_rows + size
        batch_s = time.perf_counter() - t
        stats1 = request(port, {"cmd": "stats"})
        builds1 = merged_counter(stats1, "churn", "Scorer compilations")
        hits1 = merged_counter(stats1, "churn", "Scorer cache hits")
        if builds1 != builds0 or hits1 <= hits0:
            raise AssertionError(f"scorer builds {builds0} -> {builds1}, "
                                 f"cache hits {hits0} -> {hits1} after "
                                 f"warmup")
        lat_ms = stats1["models"]["churn"]["latency_ms"]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"serve exited {rc} on SIGINT: "
                             + open(log_path).read()[-2000:])
    with open(trace) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "X"}
    serve_spans = sorted(n for n in names if n.startswith("serve."))
    if not serve_spans:
        raise AssertionError(f"the serve trace has no serve.* span: "
                             f"{sorted(names)[:10]}")
    p50, p99 = quantiles_ms(lat)
    log(f"serve_nb (CLI, TCP, 2 variants x 2 replicas on cuda:0): up in "
        f"{up_s:.3f} s; {len(items)} single-row requests from "
        f"{SERVE_CLIENTS} clients {len(items) / single_s:.1f} rows/s, "
        f"client p50 {p50:.3f} ms p99 {p99:.3f} ms; stats surface (primary "
        f"replica) p50 {lat_ms.get('p50')} ms p99 {lat_ms.get('p99')} ms; "
        f"{n_rows} rows in {2 * len(SERVE_BATCH_SIZES)} batch requests "
        f"{n_rows / batch_s:.1f} rows/s; every response byte-identical to "
        f"the batch predictor (f32 and f64); scorer builds {builds0} at "
        f"warmup, {builds1 - builds0} after, cache hits {hits0} -> {hits1}; "
        f"SIGINT drained, trace spans {', '.join(serve_spans)} [{card}]")
    serve_nb_profiled(torch, w, bp, test, batch, card)


def serve_nb_profiled(torch, w, bp, test, batch, card) -> None:
    """The runbook's single-row requests (the first
    ``PROFILED_REQUESTS``) against an in-process server on cuda:0 under
    ``torch.profiler``: the device's busy time, idle share and events per
    batch, and every replica's tensors on the card."""
    from avenir_tpu_torch.core.config import load_job_config
    from avenir_tpu_torch.serve import PredictionServer

    conf = load_job_config({
        "conf.path": os.path.join(SERVE_RUNBOOK, "serve.properties"),
        "serve.model.churn.conf": bp, "serve.port": "0"})
    srv = PredictionServer(conf, device="cuda")
    try:
        port = srv.start()
        n_rep = check_replicas_on(torch, srv, "churn", "cuda:0")
        # the first PROFILED_REQUESTS rows, the variants alternating: each
        # batch makes about 1,500 device events, and the profiler's
        # bookkeeping of them, not the traffic, is what takes the time
        items = [(("f32", "f64")[i % 2], i)
                 for i in range(PROFILED_REQUESTS)]

        def traffic():
            outs, _ = fan_out(lambda it: request(port, {
                "model": "churn", "row": test[it[1]], "variant": it[0]}),
                items)
            if any(o.get("output") != batch[v][i]
                   for (v, i), o in zip(items, outs)):
                raise AssertionError("in-process serve responses differ")

        def batches():
            return srv.pool.merged_counters("churn").get("Serve", {}).get(
                "Batches", 0)

        b0 = batches()
        by_kind, wall_s = profile_device(
            torch, traffic, {"NB scorer elementwise": "elementwise"})
        n_batches = batches() - b0
        n_launch = sum(v[1] for v in by_kind.values())
        log(f"serve_nb in process ({n_rep} replicas, tensors on cuda:0): "
            f"{len(items)} single-row requests in {n_batches} batches, "
            f"{wall_s:.3f} s ({len(items) / wall_s:.1f} rows/s) under the "
            f"profiler; {n_launch} device events, {n_launch / n_batches:.0f} "
            f"per batch")
        report_device(by_kind, wall_s, "NB scorer elementwise", card)
    finally:
        srv.stop()


def serve_knn(torch, topk, knn_data, card) -> int:
    """An in-process ``PredictionServer`` on cuda:0 with a
    ``nearestNeighbor`` model over the kNN phase's 16,384 x 256 training
    set, k = 16, batches up to 64: 512 test rows by TCP in requests of 1
    to 64 rows.  Each response equals the voting line of the batch kNN
    job on the card for its id (or, where K3's answer differs, stays in
    the one-unit oracle-confirmed contract); K3 launches once per batch
    and the plain version never; the training tensors stay where they
    were put at load.  Returns K3's and its merge's launches over the
    traffic."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.serve import PredictionServer

    d, inp, sim, vote, feats = knn_data
    batch = {l.split(",")[0]: l for l in
             read_bytes(os.path.join(d, "pred_cuda")).decode().splitlines()}
    with open(os.path.join(inp, "te-00000")) as fh:
        queries = fh.read().splitlines()[:KNN_SERVE_QUERIES]
    props = {"serve.models": "nn", "serve.model.nn.kind": "nearestNeighbor",
             "serve.model.nn.conf": vote,
             "serve.model.nn.train.data.path": os.path.join(inp, "tr-00000"),
             "serve.batch.max.size": "64", "serve.batch.max.delay.ms": "2",
             "serve.port": "0"}
    t = time.perf_counter()
    srv = PredictionServer(JobConfig(props), device="cuda")
    try:
        up_s = time.perf_counter() - t
        port = srv.start()
        n_rep = check_replicas_on(torch, srv, "nn", "cuda:0")
        adapters = [r.entry.adapter for g in srv.pool.variant_groups("nn")
                    for r in g.replicas]
        ptrs = [[x.data_ptr() for x in a.tensors()] for a in adapters]
        sizes, lo = [], 0
        while lo < len(queries):
            size = min((1, 2, 4, 7, 8, 16, 31, 32, 63, 64)[len(sizes) % 10],
                       len(queries) - lo)
            sizes.append(size)
            lo += size
        batches0 = merged_counter(request(port, {"cmd": "stats"}), "nn",
                                  "Batches")
        plain_calls = [0]
        real_plain = topk.plain_pairwise_topk

        def counted_plain(*a, **kw):
            plain_calls[0] += 1
            return real_plain(*a, **kw)

        topk.plain_pairwise_topk = counted_plain
        outs, lat = [], []
        try:
            topk.reset_launch_counts()
            t, lo = time.perf_counter(), 0
            for size in sizes:
                t1 = time.perf_counter()
                resp = request(port, {"model": "nn",
                                      "rows": queries[lo:lo + size]})
                lat.append(time.perf_counter() - t1)
                outs += resp["outputs"]
                lo += size
            traffic_s = time.perf_counter() - t
            launches = topk.K3_LAUNCHES
            merges = topk.MERGE_LAUNCHES
        finally:
            topk.plain_pairwise_topk = real_plain
        stats = request(port, {"cmd": "stats"})
        batches = merged_counter(stats, "nn", "Batches") - batches0
        if launches != batches or batches != len(sizes) or plain_calls[0]:
            raise AssertionError(f"K3 launched {launches} times for "
                                 f"{batches} batches ({len(sizes)} requests)"
                                 f", plain version called {plain_calls[0]}"
                                 f" times")
        if [[x.data_ptr() for x in a.tensors()] for a in adapters] != ptrs:
            raise AssertionError("the kNN training tensors moved")
        differ = [q.split(",")[0] for q, o in zip(queries, outs)
                  if o != batch[q.split(",")[0]]]
        if len(differ) > max(1, len(queries) // 100):
            raise AssertionError(f"{len(differ)} of {len(queries)} kNN "
                                 f"responses differ from the batch job")
        knn_serve_contract(torch, adapters[0], queries, differ, d, feats)
        p50, p99 = quantiles_ms(lat)
        lat_ms = stats["models"]["nn"]["latency_ms"]
        log(f"serve_knn (in process, {n_rep} replica on cuda:0, 16,384 x "
            f"{KNN_F} resident, k={KNN_K}): up in {up_s:.3f} s; "
            f"{len(queries)} queries in {len(sizes)} requests of 1-64 rows "
            f"{len(queries) / traffic_s:.1f} rows/s, request p50 {p50:.3f} "
            f"ms p99 {p99:.3f} ms (host clock); stats surface p50 "
            f"{lat_ms.get('p50')} ms p99 {lat_ms.get('p99')} ms; K3 "
            f"launches {launches} = batches {batches}, plain calls 0; "
            f"{len(differ)} responses differ from the batch job's voting "
            f"lines, each within the one-unit contract; training tensors "
            f"resident [{card}]")

        def traffic():
            lo = 0
            for size in sizes:
                request(port, {"model": "nn", "rows": queries[lo:lo + size]})
                lo += size

        by_kind, wall_s = profile_device(
            torch, traffic, {"K3 kernel": "topk_kernel",
                             "K3 layout prologue": "layout_kernel",
                             "K3 merge kernel": "merge_kernel"})
        log(f"serve_knn under the profiler: {len(queries)} queries in "
            f"{wall_s:.3f} s")
        report_device(by_kind, wall_s, "K3 kernel", card)
    finally:
        srv.stop()
    return {"K3serve": launches, "K3mserve": merges}


def knn_serve_contract(torch, adapter, queries, differ, d, feats) -> None:
    """A served kNN response that differs from the batch job's voting
    line must come from neighbors within the one-unit contract: distances
    within one unit of the batch pair lines, each index set carrying
    float64-oracle distances within one unit of the oracle's k
    smallest."""
    if not differ:
        return
    pairs = pair_rows(os.path.join(d, "simi_cuda"))
    t_all = torch.from_numpy(feats[:KNN_ROWS]).cuda().double()
    by_id = {q.split(",")[0]: q.split(",") for q in queries}
    for tid in differ:
        rec = by_id[tid]
        qn, qc, _, _ = adapter.sts._encode([rec], adapter.vocabs)
        dist, idx = adapter._distances(qn, qc)
        ref = pairs[tid]
        if any(abs(int(dist[0, r]) - int(ref[r][2])) > 1
               for r in range(len(ref))):
            raise AssertionError(f"served kNN row {tid} is more than one "
                                 f"unit from the batch job")
        qi = int(tid[1:])
        q = torch.from_numpy(feats[qi:qi + 1]).cuda().double()
        o = ((torch.cdist(q, t_all, compute_mode=EXACT_CDIST)[0] ** 2
              / KNN_F).sqrt() * 1000).floor().long()
        best = torch.sort(o).values[:len(ref)]
        for ix in (torch.as_tensor(idx[0], device="cuda").long(),
                   torch.tensor([int(r[0][1:]) for r in ref],
                                device="cuda")):
            if int((torch.sort(o[ix]).values - best).abs().max()) > 1:
                raise AssertionError(f"served kNN row {tid} carries wrong "
                                     f"oracle distances")


# ---------------------------------------------------------------------------
# the NB runbooks, Apriori, the Markov family and Markov serving
# ---------------------------------------------------------------------------

NB_RUNBOOKS = (("elearn_nb", "elearn", "3", "elearn.json"),
               ("usage_churn_nb", "usage", "9", "usage.json"))
FREQ_ITEMS = os.path.join(ROOT, "resource", "freq_items")
CHURN_MARKOV = os.path.join(ROOT, "resource", "churn_markov")
HMM_VITERBI = os.path.join(ROOT, "resource", "hmm_viterbi")
# bench.py:507-607's Apriori cell: 1M transactions over 50,000 items, 40
# blocks of 12 items (6 drawn a transaction) plus one tail item, three
# planted 5-itemsets at support 0.008, threshold 0.003, count mode, k 1-5
APRIORI_N, APRIORI_ITEMS, APRIORI_THRESHOLD = 1_000_000, 50_000, 0.003
APRIORI_BLOCKS, APRIORI_BLOCK_SZ, APRIORI_DRAWS = 40, 12, 6
APRIORI_PLANTED = ((3001, 3007, 3011, 3013, 3017),
                   (4001, 4202, 4303, 4404, 4505),
                   (5001, 5002, 5003, 5004, 5005))
APRIORI_CPU_ROWS = 100_000          # the card-against-CPU comparison's rows
NL = b"\n"
MARKOV_SEQS, MARKOV_CHUNK = 500_000, 65_536
MARKOV_SCORED, HMM_TAGGED, HMM_DECODED = 100_000, 200_000, 100_000


@contextlib.contextmanager
def in_dir(path):
    """Run a runbook's steps with the working directory at its layout
    (its .properties name paths relative to it)."""
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)


def write_part(path: str, data: bytes) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "part-00000"), "wb") as fh:
        fh.write(data)
    return path


def report_phase(name, by_kind, wall_s, kernel_kind, card) -> None:
    log(f"{name}: a {wall_s:.3f} s profiled run")
    report_device(by_kind, wall_s, kernel_kind, card)


def nb_runbooks(torch, histogram, card) -> None:
    """``resource/elearn_nb`` and ``resource/usage_churn_nb`` at their
    runbook sizes (4,000 generated rows, 3,200 trained, 800 scored)
    through the command line on cuda:0 and on the CPU: the model and the
    predictions byte-equal."""
    from avenir_tpu_torch import datagen

    for name, preset, seed, schema in NB_RUNBOOKS:
        book = os.path.join(ROOT, "resource", name)
        got, secs = {}, {}
        for dev in ("cuda", "cpu"):
            with in_dir(os.path.join(WORK, "nb_runbooks", name, dev)) as w:
                shutil.copy(os.path.join(book, schema), w)
                if datagen.main([preset, "4000", "--seed", seed,
                                 "--out", "work/all.csv"]) != 0:
                    raise AssertionError(f"datagen {preset} failed")
                with open("work/all.csv", "rb") as fh:
                    lines = fh.read().splitlines(keepends=True)
                write_part("work/train", b"".join(lines[:3200]))
                write_part("work/test", b"".join(lines[-800:]))

                def run(out="work"):
                    run_job(["BayesianDistribution",
                             f"-Dconf.path={book}/nb.properties",
                             "work/train", f"{out}/model", "--device", dev])
                    run_job(["BayesianPredictor",
                             f"-Dconf.path={book}/bp.properties",
                             f"-Dbayesian.model.file.path={out}/model",
                             "work/test", f"{out}/pred", "--device", dev])

                histogram.reset_launch_counts()
                t = time.perf_counter()
                run()
                secs[dev] = time.perf_counter() - t
                k1 = histogram.K1_LAUNCHES
                got[dev] = (read_bytes("work/model"), read_bytes("work/pred"))
                if dev == "cuda":
                    if k1 < 1:
                        raise AssertionError(f"{name}: no K1 launch")
                    launches = k1
                    by_kind, wall_s = profile_device(
                        torch, lambda: run("profiled"),
                        {"histogram kernel": "histogram_kernel"})
        if got["cuda"] != got["cpu"]:
            raise AssertionError(f"{name}: card and CPU outputs differ")
        log(f"{name} runbook (3,200 trained, 800 scored; train + score "
            f"through the CLI): cuda {secs['cuda']:.3f} s, cpu "
            f"{secs['cpu']:.3f} s; model and predictions byte-equal; K1 "
            f"launches {launches} [{card}]")
        report_phase(f"{name} train + score", by_kind, wall_s,
                     "histogram kernel", card)


def freq_items_runbook(work: str, dev: str) -> dict:
    """``resource/freq_items/run.sh``'s steps through the command line:
    datagen, TemporalFilter, k = 1-3 in the trans-id and id-free forms,
    the marker and the rule miner; returns every output's bytes."""
    from avenir_tpu_torch import datagen

    with in_dir(work):
        os.makedirs("work/freq_all")
        datagen.main(["timed_transactions", "500", "60", "--seed", "37",
                      "--out", "work/raw/part-00000"])
        dv = ["--device", dev]
        run_job(["TemporalFilter", f"-Dconf.path={FREQ_ITEMS}/tef.properties",
                 "work/raw", "work/trans"] + dv)
        with open("work/trans/part-r-00000") as fh:
            n = sum(1 for _ in fh)
        for k in (1, 2, 3):
            prev = [f"-Dfia.item.set.file.path=work/k{k - 1}"] if k > 1 else []
            for form, more in (("", []),
                               ("f", ["-Dfia.trans.id.output=false"])):
                run_job(["FrequentItemsApriori",
                         f"-Dconf.path={FREQ_ITEMS}/fia.properties",
                         f"-Dfia.item.set.length={k}",
                         f"-Dfia.total.tans.count={n}", *more, *prev,
                         "work/trans", f"work/k{k}{form}"] + dv)
            shutil.copy(f"work/k{k}f/part-r-00000", f"work/freq_all/part-{k}")
        run_job(["InfrequentItemMarker",
                 f"-Dconf.path={FREQ_ITEMS}/iim.properties", "work/trans",
                 "work/marked"] + dv)
        run_job(["AssociationRuleMiner",
                 f"-Dconf.path={FREQ_ITEMS}/arm.properties", "work/freq_all",
                 "work/rules"] + dv)
        return {name: read_bytes(f"work/{name}") for name in
                ("trans", "k1", "k1f", "k2", "k2f", "k3", "k3f", "marked",
                 "rules")}


def digits(x, width: int):
    """Zero-padded decimal digits of ``x`` as a uint8 ``[n, width]``
    character matrix."""
    import numpy as np
    x = np.asarray(x, np.int64)
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return ((x[:, None] // p) % 10 + 48).astype(np.uint8)


def symbols(names, codes):
    """Equal-width symbol names picked by ``codes``, as a uint8 character
    matrix ``[*codes.shape, width]``."""
    import numpy as np
    table = np.frombuffer("".join(names).encode(), np.uint8).reshape(
        len(names), -1)
    return table[codes]


def join_fields(fields):
    """Comma-joined rows of fixed-width uint8 field matrices, each row
    ending in a newline; returns the ``[n, width]`` byte matrix."""
    import numpy as np
    n = fields[0].shape[0]
    parts = []
    for i, f in enumerate(fields):
        if i:
            parts.append(np.full((n, 1), ord(","), np.uint8))
        parts.append(f)
    parts.append(np.full((n, 1), ord("\n"), np.uint8))
    return np.concatenate(parts, axis=1)


def rows_in_order(groups, n: int) -> bytes:
    """Rows built per group (``(row indices, [m, width] byte matrix)``)
    written back in row order."""
    import numpy as np
    out = np.empty(n, dtype=object)
    for idx, buf in groups:
        out[idx] = buf.view(f"S{buf.shape[1]}").ravel().tolist()
    return b"".join(out.tolist())


def write_apriori_workload(n: int):
    """bench.py's Apriori transactions (the same draws from
    ``default_rng(5)``), written by a vectorized writer: ``T%07d`` and
    seven ``I%05d`` items a row, a planted 5-itemset appended where its
    flag is set.  Returns the file's bytes."""
    import numpy as np
    rng = np.random.default_rng(5)
    B, S, D = APRIORI_BLOCKS, APRIORI_BLOCK_SZ, APRIORI_DRAWS
    block = rng.integers(0, B, n)
    perm = np.argsort(rng.random((n, S)), axis=1)[:, :D]
    ids = block[:, None] * S + perm
    tail = rng.integers(B * S, APRIORI_ITEMS, (n, 1))
    ids = np.concatenate([ids, tail], axis=1)
    flags = rng.random((n, len(APRIORI_PLANTED))) < 0.008
    fields = [np.concatenate([np.full((n, 1), ord("T"), np.uint8),
                              digits(np.arange(n), 7)], axis=1)]
    for j in range(ids.shape[1]):
        fields.append(np.concatenate([np.full((n, 1), ord("I"), np.uint8),
                                      digits(ids[:, j], 5)], axis=1))
    buf = join_fields(fields)
    suffix = [("," + ",".join(f"I{i:05d}" for i in p)).encode()
              for p in APRIORI_PLANTED]
    flagged = np.flatnonzero(flags.any(axis=1))
    parts, lo = [], 0
    for r in flagged:
        parts.append(buf[lo:r].tobytes())
        parts.append(buf[r, :-1].tobytes() + b"".join(
            suffix[j] for j in np.flatnonzero(flags[r])) + b"\n")
        lo = r + 1
    parts.append(buf[lo:].tobytes())
    return b"".join(parts)


def apriori_passes(torch, in_path: str, out_base: str, n_trans: int,
                   dev: str, profile_k: int = 0):
    """k = 1-5 over ``in_path`` (count mode, threshold 0.003) through
    ``FrequentItemsApriori`` on ``dev``; returns each pass's seconds and
    output bytes, and the profile of pass ``profile_k`` if asked."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.models.association import FrequentItemsApriori

    base = {"fia.skip.field.count": "1", "fia.tans.id.ord": "0",
            "fia.support.threshold": str(APRIORI_THRESHOLD),
            "fia.total.tans.count": str(n_trans),
            "fia.emit.trans.id": "false"}
    secs, outs, prof = [], [], None
    for k in range(1, 6):
        props = dict(base, **{"fia.item.set.length": str(k)})
        if k > 1:
            props["fia.item.set.file.path"] = f"{out_base}{k - 1}"
        job = FrequentItemsApriori(JobConfig(props), device=dev)

        def run():
            job.run(in_path, f"{out_base}{k}")
            if dev == "cuda":
                torch.cuda.synchronize()

        t = time.perf_counter()
        if k == profile_k:
            prof = profile_device(torch, run, {"support matmul": "gemm"})
        else:
            run()
        secs.append(time.perf_counter() - t)
        outs.append(read_bytes(f"{out_base}{k}"))
    return secs, outs, prof


def apriori_paths(torch, card) -> None:
    """The freq_items runbook on the card and on the CPU, byte-equal; then
    bench.py's Apriori cell at full width on the card, cold and warm (the
    incidence resident), with its census (|F2| >= 1,000, the three
    planted 5-itemsets at k = 5), and its first 100,000 transactions on
    the card and on the CPU, byte-equal."""
    from avenir_tpu_torch.models import association

    w = os.path.join(WORK, "apriori")
    t = time.perf_counter()
    rb = {dev: freq_items_runbook(os.path.join(w, f"runbook_{dev}"), dev)
          for dev in ("cuda", "cpu")}
    runbook_s = time.perf_counter() - t
    if rb["cuda"] != rb["cpu"]:
        bad = [k for k in rb["cuda"] if rb["cuda"][k] != rb["cpu"][k]]
        raise AssertionError(f"freq_items runbook outputs differ: {bad}")
    log(f"freq_items runbook through the CLI on cuda and cpu in "
        f"{runbook_s:.3f} s: {len(rb['cuda'])} outputs byte-equal "
        f"({rb['cuda']['trans'].count(NL)} transactions kept, "
        f"{rb['cuda']['k3'].count(NL)} frequent 3-itemsets, "
        f"{rb['cuda']['rules'].count(NL)} rules) [{card}]")

    t = time.perf_counter()
    data = write_apriori_workload(APRIORI_N)
    full = write_part(os.path.join(w, "trans"), data)
    cut = 0
    for _ in range(APRIORI_CPU_ROWS):
        cut = data.index(b"\n", cut) + 1
    head = write_part(os.path.join(w, "trans_head"), data[:cut])
    log(f"apriori workload: {APRIORI_N} transactions, {len(data)} bytes, "
        f"written in {time.perf_counter() - t:.3f} s")

    association._encode_cache.clear()
    association._inc_device_cache.clear()
    cold_s, cold, _ = apriori_passes(torch, full, os.path.join(w, "k"),
                                     APRIORI_N, "cuda")
    warm_s, warm, prof = apriori_passes(torch, full, os.path.join(w, "wk"),
                                        APRIORI_N, "cuda", profile_k=4)
    if warm != cold:
        raise AssertionError("warm Apriori passes differ from the cold ones")
    sizes = [o.count(NL) for o in cold]
    if sizes[1] < 1000:
        raise AssertionError(f"|F2| = {sizes[1]} < 1,000")
    found = {tuple(l.split(b",")[:5]) for l in cold[4].splitlines()}
    for p in APRIORI_PLANTED:
        want = tuple(f"I{i:05d}".encode() for i in sorted(p))
        if want not in found:
            raise AssertionError(f"planted {want} not found at k = 5")
    (entry,) = association._inc_device_cache.values()
    inc = entry[1][0]
    log(f"apriori full width (bench.py:507, {APRIORI_N} transactions, "
        f"threshold {APRIORI_THRESHOLD}, count mode) on cuda:0: |F1..F5| = "
        f"{sizes}; the three planted 5-itemsets found; resident incidence "
        f"{tuple(inc.shape)} {inc.dtype}; k-pass seconds cold "
        f"{[round(s, 3) for s in cold_s]} (sum {sum(cold_s):.3f}), warm "
        f"{[round(s, 3) for s in warm_s]} (sum {sum(warm_s):.3f}) [{card}]")
    by_kind, wall_s = prof
    t_mm, n_mm = by_kind["support matmul"]
    log(f"apriori warm k = 4 pass ({sizes[2]} candidate 3-itemsets x "
        f"{inc.shape[1]} items over {inc.shape[0]} rows): support matmul "
        f"{t_mm / 1e3:.4f} ms of device time in {n_mm} launches")
    report_phase("apriori warm k = 4 pass", by_kind, wall_s,
                 "support matmul", card)

    head_out = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        s, head_out[dev], _ = apriori_passes(
            torch, head, os.path.join(w, f"h{dev}"), APRIORI_CPU_ROWS, dev)
        log(f"apriori first {APRIORI_CPU_ROWS} transactions on {dev}: "
            f"k-pass seconds {[round(x, 3) for x in s]}")
    if head_out["cuda"] != head_out["cpu"]:
        raise AssertionError("apriori outputs on the first 100,000 "
                             "transactions differ between card and CPU")
    log(f"apriori first {APRIORI_CPU_ROWS} transactions: k = 1-5 outputs "
        f"byte-equal card and CPU (|F| = "
        f"{[o.count(NL) for o in head_out['cuda']]})")


def markov_runbooks(work: str, dev: str) -> dict:
    """``resource/churn_markov/run.sh`` and ``resource/hmm_viterbi/run.sh``
    through the command line (the Projection leg's event rows shuffled by
    a seeded permutation, which the job orders again); returns every
    output's bytes."""
    import numpy as np

    from avenir_tpu_torch import datagen

    dv = ["--device", dev]
    with in_dir(work):
        datagen.main(["churn_state_seqs", "800", "--seed", "31",
                      "--out", "work/all.csv"])
        with open("work/all.csv") as fh:
            rows = fh.read().splitlines()
        events = [f"{f[0]},{f[1]},{i - 2},{f[i]}"
                  for f in (r.split(",") for r in rows)
                  for i in range(2, len(f))]
        perm = np.random.default_rng(2024).permutation(len(events))
        write_part("work/events",
                   ("\n".join(events[i] for i in perm) + "\n").encode())
        run_job(["Projection",
                 f"-Dconf.path={CHURN_MARKOV}/projection.properties",
                 "work/events", "work/seqs"] + dv)
        with open("work/seqs/part-r-00000") as fh:
            if sorted(fh.read().splitlines()) != sorted(rows):
                raise AssertionError("Projection did not reassemble the "
                                     "sequences")
        write_part("work/train", ("\n".join(rows[:600]) + "\n").encode())
        write_part("work/test", ("\n".join(rows[-200:]) + "\n").encode())
        run_job(["MarkovStateTransitionModel",
                 f"-Dconf.path={CHURN_MARKOV}/mst.properties", "work/train",
                 "work/model"] + dv)
        run_job(["MarkovModelClassifier",
                 f"-Dconf.path={CHURN_MARKOV}/mmc.properties", "work/test",
                 "work/pred"] + dv)
        datagen.main(["hmm_seqs", "300", "--seed", "23",
                      "--out", "work/htrain/part-00000"])
        datagen.main(["hmm_obs", "40", "--seed", "67",
                      "--out", "work/obs/part-00000"])
        run_job(["HiddenMarkovModelBuilder",
                 f"-Dconf.path={HMM_VITERBI}/hmm.properties", "work/htrain",
                 "work/hmm"] + dv)
        run_job(["ViterbiStatePredictor",
                 f"-Dconf.path={HMM_VITERBI}/vit.properties",
                 "-Dhmm.model.path=work/hmm", "work/obs", "work/dec"] + dv)
        return {name: read_bytes(f"work/{name}")
                for name in ("seqs", "model", "pred", "hmm", "dec")}


def sample_chain(rng, cum, start, cls, steps: int):
    """``steps`` states of each row's chain: row i starts at ``start[i]``
    and moves by ``cum[cls[i], state]`` (cumulative transition rows)."""
    import numpy as np
    n = start.shape[0]
    seq = np.empty((n, steps), np.int64)
    seq[:, 0] = start
    u = rng.random((n, steps - 1))
    last = cum.shape[-1] - 1
    for t in range(1, steps):
        c = cum[cls, seq[:, t - 1]]
        seq[:, t] = np.minimum((u[:, t - 1:t] > c).sum(axis=1), last)
    return seq


def write_churn_sequences(n: int, seed: int) -> bytes:
    """``churn_state_seqs``-shaped rows (``E%06d``, the class, 15-25
    states of its chain: the loyal chain mixes the four states, the
    churner chain is absorbed into HH), drawn in bulk."""
    import numpy as np

    from avenir_tpu_torch.datagen import CHURN_CHAINS, CHURN_STATES

    rng = np.random.default_rng(seed)
    classes = list(CHURN_CHAINS)
    cls = rng.integers(0, len(classes), n)
    lengths = rng.integers(15, 26, n)
    cum = np.cumsum(np.stack([CHURN_CHAINS[c] for c in classes]), axis=2)
    seq = sample_chain(rng, cum, rng.integers(0, len(CHURN_STATES), n), cls,
                       int(lengths.max()))
    ids = np.concatenate([np.full((n, 1), ord("E"), np.uint8),
                          digits(np.arange(n), 6)], axis=1)
    labels = symbols(classes, cls)
    groups = []
    for L in np.unique(lengths):
        idx = np.flatnonzero(lengths == L)
        states = [symbols(CHURN_STATES, seq[idx, t]) for t in range(L)]
        groups.append((idx, join_fields([ids[idx], labels[idx]] + states)))
    return rows_in_order(groups, n)


def write_hmm_rows(n: int, seed: int, tagged: bool) -> bytes:
    """``hmm_seqs``-shaped rows (``E%06d`` then 8-20 ``obs:state`` pairs of
    the runbook's HMM) or, untagged, their observations only
    (``hmm_obs``), drawn in bulk."""
    import numpy as np

    from avenir_tpu_torch.datagen import (HMM_A, HMM_B, HMM_OBS, HMM_PI,
                                          HMM_STATES)

    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, 21, n)
    T = int(lengths.max())
    start = (rng.random((n, 1)) > np.cumsum(HMM_PI)).sum(axis=1)
    states = sample_chain(rng, np.cumsum(HMM_A, axis=1)[None],
                          np.minimum(start, len(HMM_STATES) - 1),
                          np.zeros(n, np.int64), T)
    cum_b = np.cumsum(HMM_B, axis=1)
    u = rng.random((n, T))
    obs = np.minimum((u[:, :, None] > cum_b[states]).sum(axis=2),
                     len(HMM_OBS) - 1)
    ids = np.concatenate([np.full((n, 1), ord("E"), np.uint8),
                          digits(np.arange(n), 6)], axis=1)
    groups = []
    colon = np.full((1, 1), ord(":"), np.uint8)
    for L in np.unique(lengths):
        idx = np.flatnonzero(lengths == L)
        tokens = []
        for t in range(L):
            o = symbols(HMM_OBS, obs[idx, t])
            if tagged:
                o = np.concatenate([o, np.repeat(colon, len(idx), 0),
                                    symbols(HMM_STATES, states[idx, t])],
                                   axis=1)
            tokens.append(o)
        groups.append((idx, join_fields([ids[idx]] + tokens)))
    return rows_in_order(groups, n)


def markov_paths(torch, card) -> dict:
    """The churn_markov and hmm_viterbi runbooks on the card and on the
    CPU, byte-equal; then the family at a real size through the command
    line, card against CPU: the trainer streamed over 500,000 sequences
    (cold, then warm off the pair cache), the classifier at float64 and
    float32 on 100,000, the HMM builder on 200,000 tagged rows and Viterbi
    on 100,000 observation rows.  Returns the serving phase's inputs."""
    w = os.path.join(WORK, "markov")
    t = time.perf_counter()
    rb = {dev: markov_runbooks(os.path.join(w, f"runbook_{dev}"), dev)
          for dev in ("cuda", "cpu")}
    runbook_s = time.perf_counter() - t
    if rb["cuda"] != rb["cpu"]:
        bad = [k for k in rb["cuda"] if rb["cuda"][k] != rb["cpu"][k]]
        raise AssertionError(f"Markov runbook outputs differ: {bad}")
    log(f"churn_markov + hmm_viterbi runbooks through the CLI on cuda and "
        f"cpu in {runbook_s:.3f} s: {len(rb['cuda'])} outputs byte-equal")

    t = time.perf_counter()
    seqs = write_churn_sequences(MARKOV_SEQS, 31)
    train = write_part(os.path.join(w, "train"), seqs)
    cut = 0
    for _ in range(MARKOV_SCORED):
        cut = seqs.index(b"\n", cut) + 1
    scored = write_part(os.path.join(w, "scored"), seqs[:cut])
    tagged = write_part(os.path.join(w, "tagged"),
                        write_hmm_rows(HMM_TAGGED, 23, True))
    obs = write_part(os.path.join(w, "obs"),
                     write_hmm_rows(HMM_DECODED, 67, False))
    log(f"markov data: {MARKOV_SEQS} sequences, {HMM_TAGGED} tagged and "
        f"{HMM_DECODED} observation rows written in "
        f"{time.perf_counter() - t:.3f} s")

    def steps(d: str, cache: bool):
        """(label, argv, output) of the real-size runs writing under
        ``d``; the trainer with the pair cache when ``cache``."""
        model, hmm = os.path.join(d, "model"), os.path.join(d, "hmm")
        mst = [f"-Dconf.path={CHURN_MARKOV}/mst.properties",
               f"-Dpipeline.chunk.rows={MARKOV_CHUNK}"]
        if cache:
            mst += ["-Dingest.cache.enable=true",
                    f"-Dingest.cache.dir={os.path.join(d, 'paircache')}"]
        mmc = [f"-Dconf.path={CHURN_MARKOV}/mmc.properties",
               f"-Dmm.model.path={model}"]
        out = [("trainer cold", ["MarkovStateTransitionModel", *mst, train,
                                 model], model)]
        if cache:
            warm = os.path.join(d, "model_warm")
            out.append(("trainer warm", ["MarkovStateTransitionModel", *mst,
                                         train, warm], warm))
        return out + [
            ("classifier f64", ["MarkovModelClassifier", *mmc, scored,
                                os.path.join(d, "pred64")],
             os.path.join(d, "pred64")),
            ("classifier f32", ["MarkovModelClassifier", *mmc,
                                "-Dmmc.score.precision=float32", scored,
                                os.path.join(d, "pred32")],
             os.path.join(d, "pred32")),
            ("HMM builder", ["HiddenMarkovModelBuilder",
                             f"-Dconf.path={HMM_VITERBI}/hmm.properties",
                             tagged, hmm], hmm),
            ("Viterbi", ["ViterbiStatePredictor",
                         f"-Dconf.path={HMM_VITERBI}/vit.properties",
                         f"-Dhmm.model.path={hmm}", obs,
                         os.path.join(d, "dec")], os.path.join(d, "dec"))]

    secs, got = {"cuda": {}, "cpu": {}}, {"cuda": {}, "cpu": {}}
    card_steps = steps(os.path.join(w, "cuda"), cache=True)
    for dev, todo in (("cuda", card_steps),
                      ("cpu", steps(os.path.join(w, "cpu"), cache=False))):
        for label, argv, out in todo:
            t = time.perf_counter()
            text = run_job(argv + ["--device", dev])
            secs[dev][label] = time.perf_counter() - t
            got[dev][label] = read_bytes(out)
            if label == "trainer cold" and counter(
                    text, "Markov", "Transitions") <= 0:
                raise AssertionError("the trainer counted no transition")
    if got["cuda"]["trainer warm"] != got["cuda"]["trainer cold"]:
        raise AssertionError("the warm trainer's model differs from the "
                             "cold one")
    bad = [label for label in got["cpu"]
           if got["cpu"][label] != got["cuda"][label]]
    if bad:
        raise AssertionError(f"Markov {bad}: card and CPU outputs differ")
    log("markov real size on cuda:0 and on the CPU, every output "
        "byte-equal: " + "; ".join(
            f"{label} cuda {secs['cuda'][label]:.3f} s"
            + (f" cpu {secs['cpu'][label]:.3f} s"
               if label in secs["cpu"] else "")
            for label, _, _ in card_steps) + f" [{card}]")
    secs = secs["cuda"]
    log(f"markov rates on cuda:0: trainer {MARKOV_SEQS / secs['trainer cold']:.0f}"
        f" sequences/s cold, {MARKOV_SEQS / secs['trainer warm']:.0f} warm; "
        f"classifier {MARKOV_SCORED / secs['classifier f64']:.0f} rows/s f64, "
        f"{MARKOV_SCORED / secs['classifier f32']:.0f} f32; HMM builder "
        f"{HMM_TAGGED / secs['HMM builder']:.0f} rows/s; Viterbi "
        f"{HMM_DECODED / secs['Viterbi']:.0f} rows/s [{card}]")
    for label, argv, _ in card_steps:
        if label in ("trainer warm", "classifier f32"):
            continue
        prof_argv = [a for a in argv if not a.startswith("-Dingest.cache")]
        prof_argv[-1] = prof_argv[-1] + "_profiled"
        kind = {"trainer cold": ("count (index_add_)", "index"),
                "HMM builder": ("count (index_add_)", "index"),
                "classifier f64": ("gather", "index"),
                "Viterbi": ("max / argmax", "reduce")}[label]
        by_kind, wall_s = profile_device(
            torch, lambda: run_job(prof_argv + ["--device", "cuda"]),
            {kind[0]: kind[1]})
        report_phase(f"markov {label}", by_kind, wall_s, kind[0], card)
    return {"model": os.path.join(w, "runbook_cuda", "work", "model"),
            "test": os.path.join(w, "runbook_cuda", "work", "test")}


def serve_markov(torch, card, arts) -> None:
    """``python -m avenir_tpu_torch serve`` with the churn_markov
    runbook's model as a ``markovClassifier`` in f32 and f64 variants (two
    replicas each, batches to 64, 2 ms window) on cuda:0: its 200 test
    rows from 16 concurrent single-row TCP clients, then batch requests of
    1-64 rows; every response byte-equal to the batch classifier's line
    on the card, no scorer built after warmup."""
    import re
    import signal

    w = os.path.join(WORK, "serve_markov")
    os.makedirs(w)
    mmc = os.path.join(w, "mmc.properties")
    with open(os.path.join(CHURN_MARKOV, "mmc.properties")) as src, \
            open(mmc, "w") as fh:
        fh.write(src.read() + f"\nmm.model.path={arts['model']}\n")
    with open(os.path.join(arts["test"], "part-00000")) as fh:
        test = fh.read().splitlines()
    batch = {}
    for variant, precision in (("f32", "float32"), ("f64", "float64")):
        out = os.path.join(w, f"pred_{variant}")
        run_job(["MarkovModelClassifier", f"-Dconf.path={mmc}",
                 f"-Dmmc.score.precision={precision}", arts["test"], out,
                 "--device", "cuda"])
        batch[variant] = read_bytes(out).decode().splitlines()
    conf = os.path.join(w, "serve.properties")
    with open(conf, "w") as fh:
        fh.write("serve.models=seg\nserve.model.seg.kind=markovClassifier\n"
                 f"serve.model.seg.conf={mmc}\n"
                 "serve.model.seg.variants=f32,f64\nserve.pool.replicas=2\n"
                 "serve.batch.max.size=64\nserve.batch.max.delay.ms=2\n"
                 "serve.queue.max.depth=256\n")
    log_path = os.path.join(w, "server.log")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t_start = time.perf_counter()
    with open(log_path, "w") as log_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch", "serve",
             f"-Dconf.path={conf}", "-Dserve.port=0"], cwd=w, env=env,
            stdout=log_fh, stderr=subprocess.STDOUT)
    try:
        port = None
        while port is None:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}: "
                                     + open(log_path).read()[-2000:])
            if time.perf_counter() - t_start > 180:
                raise AssertionError("serve did not come up in 180 s")
            m = re.search(r"serving .* on ([\w.]+):(\d+)",
                          open(log_path).read())
            port = int(m.group(2)) if m else None
            time.sleep(0.1)
        up_s = time.perf_counter() - t_start
        stats0 = request(port, {"cmd": "stats"})
        seg = stats0["models"]["seg"]
        devices = [r["device"] for v in seg["variants"].values()
                   for r in v["replicas"]]
        if devices != ["cuda:0"] * 4:
            raise AssertionError(f"serve replicas on {devices}, not 2 x 2 "
                                 f"on cuda:0")
        builds0 = merged_counter(stats0, "seg", "Scorer compilations")
        hits0 = merged_counter(stats0, "seg", "Scorer cache hits")
        if builds0 != 2 * 2 * 7 * 2:
            raise AssertionError(f"warmup built {builds0} scorers, not 56")
        items = [(v, i) for v in ("f32", "f64") for i in range(len(test))]
        t = time.perf_counter()
        outs, lat = fan_out(lambda it: request(port, {
            "model": "seg", "row": test[it[1]], "variant": it[0]}), items)
        single_s = time.perf_counter() - t
        bad = [(v, i, o) for (v, i), o in zip(items, outs)
               if o.get("output") != batch[v][i] or o.get("variant") != v]
        if bad:
            raise AssertionError(f"{len(bad)} single-row responses differ "
                                 f"from the batch classifier, e.g. {bad[0]}")
        n_rows, t = 0, time.perf_counter()
        for v in ("f32", "f64"):
            lo = 0
            for size in SERVE_BATCH_SIZES:
                resp = request(port, {"model": "seg", "variant": v,
                                      "rows": test[lo:lo + size]})
                if resp.get("outputs") != batch[v][lo:lo + size]:
                    raise AssertionError(f"a {size}-row {v} response "
                                         f"differs from the batch lines")
                lo, n_rows = lo + size, n_rows + size
        batch_s = time.perf_counter() - t
        stats1 = request(port, {"cmd": "stats"})
        builds1 = merged_counter(stats1, "seg", "Scorer compilations")
        hits1 = merged_counter(stats1, "seg", "Scorer cache hits")
        if builds1 != builds0 or hits1 <= hits0:
            raise AssertionError(f"scorer builds {builds0} -> {builds1}, "
                                 f"cache hits {hits0} -> {hits1} after "
                                 f"warmup")
        lat_ms = stats1["models"]["seg"]["latency_ms"]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"serve exited {rc} on SIGINT: "
                             + open(log_path).read()[-2000:])
    p50, p99 = quantiles_ms(lat)
    log(f"serve_markov (CLI, TCP, 2 variants x 2 replicas on cuda:0): up in "
        f"{up_s:.3f} s; {len(items)} single-row requests from "
        f"{SERVE_CLIENTS} clients {len(items) / single_s:.1f} rows/s, client "
        f"p50 {p50:.3f} ms p99 {p99:.3f} ms; stats surface (primary replica) "
        f"p50 {lat_ms.get('p50')} ms p99 {lat_ms.get('p99')} ms; {n_rows} "
        f"rows in {2 * len(SERVE_BATCH_SIZES)} batch requests "
        f"{n_rows / batch_s:.1f} rows/s; every response byte-identical to the "
        f"batch classifier (f32 and f64); scorer builds {builds0} at warmup, "
        f"{builds1 - builds0} after [{card}]")
    serve_markov_profiled(torch, conf, test, batch, card)


def serve_markov_profiled(torch, conf, test, batch, card) -> None:
    """The single-row traffic against an in-process server on cuda:0
    under ``torch.profiler``: device busy time and idle share, every
    replica's table on the card."""
    from avenir_tpu_torch.core.config import load_job_config
    from avenir_tpu_torch.serve import PredictionServer

    srv = PredictionServer(load_job_config({"conf.path": conf,
                                            "serve.port": "0"}),
                           device="cuda")
    try:
        port = srv.start()
        n_rep = check_replicas_on(torch, srv, "seg", "cuda:0")
        items = [(("f32", "f64")[i % 2], i) for i in range(len(test))]

        def traffic():
            outs, _ = fan_out(lambda it: request(port, {
                "model": "seg", "row": test[it[1]], "variant": it[0]}), items)
            if any(o.get("output") != batch[v][i]
                   for (v, i), o in zip(items, outs)):
                raise AssertionError("in-process serve responses differ")

        by_kind, wall_s = profile_device(torch, traffic,
                                         {"log-odds gather": "index"})
        log(f"serve_markov in process ({n_rep} replicas, tables on cuda:0): "
            f"{len(items)} single-row requests, {wall_s:.3f} s "
            f"({len(items) / wall_s:.1f} rows/s) under the profiler")
        report_device(by_kind, wall_s, "log-odds gather", card)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the count-table family: MI and correlations, the tree, the PST, text, LR
# ---------------------------------------------------------------------------

MI_BOOK = os.path.join(ROOT, "resource", "hosp_readmit_mi")
CRAMER_BOOK = os.path.join(ROOT, "resource", "churn_cramer")
SUITE_BOOK = os.path.join(ROOT, "resource", "correlation_suite")
DTB_BOOK = os.path.join(ROOT, "resource", "decision_tree")
RT_BOOK = os.path.join(ROOT, "resource", "retarget_tree")
PST_BOOK = os.path.join(ROOT, "resource", "visit_pst")
WC_BOOK = os.path.join(ROOT, "resource", "word_count")
TC_BOOK = os.path.join(ROOT, "resource", "text_classify")
LR_BOOK = os.path.join(ROOT, "resource", "logistic_regression")
# bench.py:822-880's shared-scan cell: 400,000 churn rows (50,000 seeded
# rows repeated), the all-binned schema, 65,536-row chunks
SHARED_ROWS, SHARED_CHUNK = 400_000, 65_536
SHARED_SCAN_SCHEMA = {"fields": [
    {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
    {"name": "plan", "ordinal": 1, "dataType": "categorical",
     "feature": True, "cardinality": ["planA", "planB"]},
    {"name": "minUsed", "ordinal": 2, "dataType": "int", "feature": True,
     "min": 0, "max": 2200, "bucketWidth": 200},
    {"name": "dataUsed", "ordinal": 3, "dataType": "int", "feature": True,
     "min": 0, "max": 1000, "bucketWidth": 100},
    {"name": "csCall", "ordinal": 4, "dataType": "int", "feature": True,
     "min": 0, "max": 14, "bucketWidth": 2},
    {"name": "csEmail", "ordinal": 5, "dataType": "int", "feature": True,
     "min": 0, "max": 22, "bucketWidth": 4},
    {"name": "network", "ordinal": 6, "dataType": "int", "feature": True,
     "min": 0, "max": 12, "bucketWidth": 2},
    {"name": "churned", "ordinal": 7, "dataType": "categorical",
     "cardinality": ["N", "Y"]}]}
# bench.py:1327's level pass at full width; its CPU comparison's rows
LEVEL_N, LEVEL_PATHS, LEVEL_PREDS, LEVEL_CLASSES = 2_000_000, 8, 64, 2
LEVEL_CPU_ROWS = 200_000
DTB_STREAM_ROWS, DTB_STREAM_CHUNK = 1_000_000, 65_536
TREE_SERVE_ROWS = 200
PST_ROWS, TEXT_ROWS = 200_000, 200_000
TEXT_TRAIN = 160_000                 # the rest are scored
TEXT_WIDE_N, TEXT_WIDE_V = 2_000_000, 40_000   # K1's cluster-route text case
LR_ROWS, LR_ITERS, LR_RTOL = 1_000_000, 10, 1e-9


def on_both(fn) -> dict:
    """``fn(dev)`` on the card and on the CPU; each result and its
    host-clock seconds."""
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        out[dev] = fn(dev)
        secs[dev] = time.perf_counter() - t
    return out, secs


def same_on_both(label, out) -> None:
    if out["cuda"] != out["cpu"]:
        bad = ([k for k in out["cuda"] if out["cuda"][k] != out["cpu"][k]]
               if isinstance(out["cuda"], dict) else label)
        raise AssertionError(f"{label}: card and CPU outputs differ: {bad}")


def dir_bytes(root: str) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def mi_corr_runbooks(work: str, dev: str) -> dict:
    """``resource/hosp_readmit_mi``, ``resource/churn_cramer`` and the two
    correlation legs of ``resource/correlation_suite`` through the command
    line; every output's bytes."""
    from avenir_tpu_torch import datagen

    dv = ["--device", dev]
    with in_dir(work):
        shutil.copy(os.path.join(MI_BOOK, "hosp_readmit.json"), work)
        shutil.copy(os.path.join(CRAMER_BOOK, "churn.json"), work)
        datagen.main(["hosp_readmit", "6000", "--seed", "13",
                      "--out", "work/hosp/part-00000"])
        run_job(["MutualInformation", f"-Dconf.path={MI_BOOK}/mi.properties",
                 "work/hosp", "work/mi"] + dv)
        datagen.main(["telecom_churn", "3000", "--seed", "29",
                      "--out", "work/churn/part-00000"])
        run_job(["CramerCorrelation",
                 f"-Dconf.path={CRAMER_BOOK}/cramer.properties",
                 "work/churn", "work/cramer"] + dv)
        run_job(["NumericalCorrelation",
                 f"-Dconf.path={SUITE_BOOK}/numerical.properties",
                 "work/churn", "work/num"] + dv)
        run_job(["HeterogeneityReductionCorrelation",
                 f"-Dconf.path={SUITE_BOOK}/hetero.properties",
                 "work/churn", "work/het"] + dv)
        return {k: read_bytes(f"work/{k}")
                for k in ("mi", "cramer", "num", "het")}


def mi_corr_paths(torch, histogram, card) -> tuple:
    """The MI and correlation runbooks on the card and on the CPU, then
    bench.py's shared-scan cell: MI monolithic, streamed in 65,536-row
    chunks writing the ingest cache, and warm off it; Cramer monolithic;
    card against CPU, K1's launches per MI run.  Returns the main path's
    K1 launches, the MI shape's histogram case and the shared-scan cell's
    input and schema paths."""
    import numpy as np

    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.datagen import gen_telecom_churn

    w = os.path.join(WORK, "mi_corr")
    histogram.reset_launch_counts()      # the CPU runs launch no kernel
    rb, secs = on_both(lambda dev: mi_corr_runbooks(
        os.path.join(w, f"runbook_{dev}"), dev))
    runbook_k1 = histogram.K1_LAUNCHES
    same_on_both("MI / correlation runbooks", rb)
    if runbook_k1 != 1:
        raise AssertionError(f"the MI runbook launched K1 {runbook_k1} "
                             f"times, not once")
    log(f"hosp_readmit_mi, churn_cramer and correlation_suite's two legs "
        f"through the CLI: cuda {secs['cuda']:.3f} s, cpu "
        f"{secs['cpu']:.3f} s; {len(rb['cuda'])} outputs byte-equal; MI's "
        f"K1 launches 1 [{card}]")

    # the shared-scan cell
    t = time.perf_counter()
    base = "".join(",".join(r) + "\n" for r in gen_telecom_churn(50_000,
                                                                 seed=5))
    inp = write_part(os.path.join(w, "shared_in"),
                     (base * (SHARED_ROWS // 50_000)).encode())
    schema = os.path.join(w, "shared.json")
    with open(schema, "w") as fh:
        json.dump(SHARED_SCAN_SCHEMA, fh)
    log(f"shared-scan cell: {SHARED_ROWS} churn rows written in "
        f"{time.perf_counter() - t:.3f} s")
    mi = ["MutualInformation", f"-Dfeature.schema.file.path={schema}"]
    cache = [f"-Dpipeline.chunk.rows={SHARED_CHUNK}",
             "-Dingest.cache.enable=true",
             f"-Dingest.cache.dir={os.path.join(w, 'ingestcache')}"]
    cramer = ["CramerCorrelation", f"-Dfeature.schema.file.path={schema}",
              "-Dsource.attributes=1", "-Ddest.attributes=7"]
    runs = [("MI monolithic", mi, 1), ("MI streamed cold", mi + cache, 7),
            ("MI streamed warm", mi + cache, 7), ("Cramer", cramer, 0)]
    got, times, k1 = {}, {}, {}
    for label, argv, want_k1 in runs:
        out = os.path.join(w, label.replace(" ", "_"))
        histogram.reset_launch_counts()
        t = time.perf_counter()
        run_job(argv + [inp, out, "--device", "cuda"])
        times[label] = time.perf_counter() - t
        k1[label] = histogram.K1_LAUNCHES
        got[label] = read_bytes(out)
        if k1[label] != want_k1:
            raise AssertionError(f"{label}: {k1[label]} K1 launches, not "
                                 f"{want_k1}")
    for label in ("MI streamed cold", "MI streamed warm"):
        if got[label] != got["MI monolithic"]:
            raise AssertionError(f"{label}'s bytes differ from the "
                                 f"monolithic run's")
    cpu = {}
    for label, argv, _ in (runs[0], runs[3]):
        out = os.path.join(w, "cpu_" + label.replace(" ", "_"))
        t = time.perf_counter()
        run_job(argv + [inp, out, "--device", "cpu"])
        times["cpu " + label] = time.perf_counter() - t
        cpu[label] = read_bytes(out)
        if cpu[label] != got[label]:
            raise AssertionError(f"{label}: card and CPU outputs differ")
    log("shared-scan cell on cuda:0 (every MI run's bytes equal, and equal "
        "to the CPU's): " + "; ".join(
            f"{label} {times[label]:.3f} s ({SHARED_ROWS / times[label]:.0f} "
            f"rows/s, K1 {k1[label]})" for label, _, _ in runs)
        + f"; cpu MI {times['cpu MI monolithic']:.3f} s, Cramer "
        f"{times['cpu Cramer']:.3f} s [{card}]")
    prof_out = os.path.join(w, "MI_profiled")
    by_kind, wall_s = profile_device(torch, lambda: run_job(
        mi + [inp, prof_out, "--device", "cuda"]),
        {"histogram kernel": "histogram_kernel", "pair count": "index"})
    report_phase(f"MI monolithic ({SHARED_ROWS} rows)", by_kind, wall_s,
                 "histogram kernel", card)

    # K1's case at the MI job's own call: the encoded 400,000 rows
    enc = DatasetEncoder(FeatureSchema.from_file(schema))
    ds = enc.encode_path(inp, ",")
    C, B = len(ds.class_vocab), max(ds.num_bins)
    x, y = np.ascontiguousarray(ds.x), np.ascontiguousarray(ds.y)
    case = ("K1mi", "MI monolithic call (bench.py:840 cell)", C, B, None,
            lambda: (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(),
                     None))
    return {"K1mi": k1["MI monolithic"]}, case, (inp, schema)


# ---------------------------------------------------------------------------
# the shared scan: core/multiscan, the fold certificate, the discriminants
# ---------------------------------------------------------------------------

MULTISCAN_BOOK = os.path.join(ROOT, "resource", "multiscan")
FISHER_BOOK = os.path.join(ROOT, "resource", "fisher_discriminant")
# bench.py:840's jobs over the cell, and the multiscan runbook's fourth
SHARED_JOBS = (("nb", "BayesianDistribution", {}),
               ("mi", "MutualInformation", {}),
               ("corr", "CramerCorrelation", {"source.attributes": "1",
                                              "dest.attributes": "7"}),
               ("stats", "NumericalAttrStats", {"attr.list": "2,3",
                                                "cond.attr.ord": "7"}))
SHARED_REPS = 2


def multiscan_runbooks(work: str, dev: str) -> dict:
    """``resource/multiscan/run.sh`` (its four jobs through ``python -m
    avenir_tpu_torch multi``, recorded with ``--profile-dir``),
    ``resource/fisher_discriminant/run.sh`` and
    ``resource/correlation_suite``'s NumericalAttrStats leg; every
    output's bytes."""
    from avenir_tpu_torch import datagen

    dv = ["--device", dev]
    with in_dir(work):
        for f in ("workflow.properties", "teleComChurnBinned.json"):
            shutil.copy(os.path.join(MULTISCAN_BOOK, f), work)
        datagen.main(["telecom_churn", "20000", "--seed", "31",
                      "--out", "work/in/part-00000"])
        err = run_job(["multi", "-Dconf.path=workflow.properties",
                       "work/in", "work/out", "--profile-dir=work/prof"]
                      + dv)
        if "standalone" in err:
            raise AssertionError(f"a runbook job left the shared scan: "
                                 f"{err}")
        # --profile-dir's torch.profiler trace; on the card it must hold
        # device events (kernels or copies)
        (trace,) = os.listdir("work/prof")
        with open(os.path.join("work/prof", trace)) as fh:
            cats = {e.get("cat") for e in json.load(fh)["traceEvents"]}
        if dev == "cuda" and not cats & {"kernel", "gpu_memcpy"}:
            raise AssertionError(f"--profile-dir's trace holds no device "
                                 f"event: {sorted(map(str, cats))}")
        datagen.main(["telecom_churn", "3000", "--seed", "29",
                      "--out", "work/churn/part-00000"])
        run_job(["FisherDiscriminant",
                 f"-Dconf.path={FISHER_BOOK}/fisher.properties",
                 "work/churn", "work/fisher"] + dv)
        run_job(["NumericalAttrStats",
                 f"-Dconf.path={SUITE_BOOK}/stats.properties",
                 "work/churn", "work/stats"] + dv)
        out = {j: read_bytes(f"work/out/{j}")
               for j in ("nb", "mi", "corr", "stats")}
        out.update({k: read_bytes(f"work/{k}") for k in ("fisher", "stats")})
        return out


def shared_defines(schema: str, jids) -> list:
    """The cell's manifest (``multi.*`` keys) as command-line defines."""
    out = [f"-Dmulti.jobs={','.join(jids)}",
           f"-Dpipeline.chunk.rows={SHARED_CHUNK}",
           "-Dpipeline.prefetch.depth=2"]
    for jid, cls, props in SHARED_JOBS:
        if jid not in jids:
            continue
        out.append(f"-Dmulti.job.{jid}.class={cls}")
        if jid != "stats":
            out.append(f"-Dmulti.job.{jid}.feature.schema.file.path="
                       f"{schema}")
        out += [f"-Dmulti.job.{jid}.{k}={v}" for k, v in props.items()]
    return out


def multiscan_paths(torch, histogram, card, inp: str, schema: str) -> tuple:
    """The shared scan on the card: the multiscan, Fisher and stats
    runbooks on the card and on the CPU; bench.py:840's cell (NB + MI +
    Cramer over 400,000 rows in 65,536-row chunks at depth 2) standalone
    and fused, K1's launches fused = NB's + MI's standalone, the copies a
    chunk and the fused pass's device idle share; the four-job manifest
    cold and warm off the tee'd cache, on the CPU, and killed by a worker
    death and resumed; the fold certificate (``algebra.run_dynamic``) on
    [cuda:0] and [cuda:0] * 4.  Every output byte-equal to its standalone
    run and to the CPU's.  Returns the fused pass's K1 launches and K1's
    case at its chunk."""
    import numpy as np

    from avenir_tpu_torch.cli import job_resolver
    from avenir_tpu_torch.core import algebra, multiscan, obs, pipeline
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import _NBStreamState
    from avenir_tpu_torch.parallel.mesh import make_mesh

    w = os.path.join(WORK, "multiscan")
    cuda0 = torch.device("cuda", 0)
    histogram.reset_launch_counts()
    rb, secs = on_both(lambda dev: multiscan_runbooks(
        os.path.join(w, f"runbook_{dev}"), dev))
    same_on_both("multiscan / fisher / stats runbooks", rb)
    log(f"multiscan runbook (4 jobs fused), fisher_discriminant and "
        f"correlation_suite's NumericalAttrStats through the CLI: cuda "
        f"{secs['cuda']:.3f} s, cpu {secs['cpu']:.3f} s; {len(rb['cuda'])} "
        f"outputs byte-equal [{card}]")

    # the cell: standalone against fused, in turns, the best of each
    three = ("nb", "mi", "corr")
    alone, t_alone, k_alone = {}, {}, {}
    fused3, t_fused, k_fused = None, [], None
    copies = chunks = 0
    tr = obs.get_tracer()
    for rep in range(SHARED_REPS):
        for jid, cls, props in SHARED_JOBS:
            out = os.path.join(w, f"alone_{jid}")
            argv = [cls] + ([f"-Dfeature.schema.file.path={schema}"]
                            if jid != "stats" else []) + [
                f"-D{k}={v}" for k, v in props.items()] + [
                f"-Dpipeline.chunk.rows={SHARED_CHUNK}", inp, out,
                "--device", "cuda"]
            histogram.reset_launch_counts()
            t = time.perf_counter()
            run_job(argv)
            t_alone.setdefault(jid, []).append(time.perf_counter() - t)
            k_alone[jid] = (histogram.K1_LAUNCHES, histogram.K2_LAUNCHES)
            got = read_bytes(out)
            if alone.setdefault(jid, got) != got:
                raise AssertionError(f"standalone {jid} changed between runs")
        cfg = JobConfig(dict(
            a[2:].split("=", 1) for a in shared_defines(schema, three)))
        histogram.reset_launch_counts()
        obs.configure(enabled=True)
        tr.clear()
        t = time.perf_counter()
        multiscan.run_multi(cfg, inp, os.path.join(w, "fused3"),
                            job_resolver(cuda0), mesh=make_mesh([cuda0]))
        torch.cuda.synchronize()
        t_fused.append(time.perf_counter() - t)
        copies = len(tr.spans("ingest.h2d"))
        chunks = sum(1 for g in tr.records() if isinstance(g, obs.Gauge)
                     and g.name == "multiscan.fanout.width")
        obs.configure(enabled=False)
        tr.clear()
        k_fused = (histogram.K1_LAUNCHES, histogram.K2_LAUNCHES)
        fused3 = {j: read_bytes(os.path.join(w, "fused3", j)) for j in three}
    for j in three:
        if fused3[j] != alone[j]:
            raise AssertionError(f"fused {j}'s bytes differ from its "
                                 f"standalone run's")
    want_k1 = k_alone["nb"][0] + k_alone["mi"][0]
    n_chunks = -(-SHARED_ROWS // SHARED_CHUNK)
    if (k_alone["nb"][0], k_alone["mi"][0]) != (n_chunks, n_chunks):
        raise AssertionError(f"standalone K1 launches {k_alone}, not "
                             f"{n_chunks} for NB and MI")
    if k_fused != (want_k1, 0):
        raise AssertionError(f"the fused pass launched K1/K2 {k_fused}, not "
                             f"({want_k1}, 0)")
    if (chunks, copies) != (n_chunks, 2 * n_chunks):
        raise AssertionError(f"{copies} copies over {chunks} chunks, not "
                             f"two a chunk (NB and MI share one)")
    best = {j: min(t_alone[j]) for j in t_alone}
    alone_s = sum(best[j] for j in three)
    fused_s = min(t_fused)
    log(f"shared-scan cell ({SHARED_ROWS} rows, {SHARED_CHUNK}-row chunks, "
        f"depth 2, best of {SHARED_REPS}): standalone NB {best['nb']:.3f} s "
        f"+ MI {best['mi']:.3f} s + Cramer {best['corr']:.3f} s = "
        f"{alone_s:.3f} s; fused {fused_s:.3f} s; fused / standalone "
        f"{fused_s / alone_s:.4f}; H2D copies a chunk {copies / chunks:.2f} "
        f"({copies} over {chunks} chunks); K1 launches fused {k_fused[0]} = "
        f"NB {k_alone['nb'][0]} + MI {k_alone['mi'][0]}, K2 {k_fused[1]} "
        f"[{card}]")
    by_kind, wall_s = profile_device(torch, lambda: multiscan.run_multi(
        cfg, inp, os.path.join(w, "fused3_profiled"), job_resolver(cuda0),
        mesh=make_mesh([cuda0])),
        {"histogram kernel": "histogram_kernel", "pair count": "index"})
    report_phase("fused NB + MI + Cramer pass", by_kind, wall_s,
                 "histogram kernel", card)

    # the four-job manifest: cold (tees the cache), warm, the CPU, a kill
    four = ("nb", "mi", "corr", "stats")
    cache = [f"-Dingest.cache.dir={os.path.join(w, 'cache')}",
             "-Dingest.cache.enable=true"]
    outs, times, k = {}, {}, {}
    for label, dev, extra in (("cold", "cuda", cache), ("warm", "cuda", cache),
                              ("cpu", "cpu", [])):
        out = os.path.join(w, f"four_{label}")
        histogram.reset_launch_counts()
        t = time.perf_counter()
        err = run_job(["multi"] + shared_defines(schema, four) + extra
                      + [inp, out, "--device", dev])
        times[label] = time.perf_counter() - t
        k[label] = (histogram.K1_LAUNCHES, histogram.K2_LAUNCHES)
        if "standalone" in err:
            raise AssertionError(f"four-job {label} pass: {err}")
        outs[label] = {j: read_bytes(os.path.join(out, j)) for j in four}
        if outs[label] != {j: alone[j] for j in four}:
            bad = [j for j in four if outs[label][j] != alone[j]]
            raise AssertionError(f"four-job {label} pass: {bad} differ "
                                 f"from the standalone runs")
    if k["cold"] != (want_k1, 0) or k["warm"] != (want_k1, 0) \
            or k["cpu"] != (0, 0):
        raise AssertionError(f"four-job K1/K2 launches {k}")
    if not os.listdir(os.path.join(w, "cache")):
        raise AssertionError("the cold pass published no cache artifact")

    out = os.path.join(w, "four_killed")
    kill = ["multi"] + shared_defines(schema, four) + [
        "-Dcheckpoint.interval.chunks=1", inp, out, "--device", "cuda"]
    try:
        run_job(kill + ["-Dfault.inject.plan=worker_death@3"])
    except RuntimeError as e:
        died = str(e)
    else:
        raise AssertionError("worker_death@3 did not kill the fused pass")
    with open(os.path.join(out, "_multiscan.ckpt"), "rb") as fh:
        ck = pickle.load(fh)
    if not isinstance(ck["carry"].get("mi"), dict):
        raise AssertionError("the sidecar lacks MI's dict carry")
    histogram.reset_launch_counts()
    t = time.perf_counter()
    run_job(kill + ["--resume"])
    t_resume = time.perf_counter() - t
    resumed = {j: read_bytes(os.path.join(out, j)) for j in four}
    if resumed != outs["cold"]:
        raise AssertionError("the resumed pass's bytes differ from the "
                             "clean run's")
    left = n_chunks - (ck["chunk_index"] + 1)
    if histogram.K1_LAUNCHES != 2 * left:
        raise AssertionError(f"the resume launched K1 "
                             f"{histogram.K1_LAUNCHES} times, not 2 x {left}")
    if os.path.exists(os.path.join(out, "_multiscan.ckpt")):
        raise AssertionError("the resumed pass left its sidecar")
    log(f"four-job manifest (+ NumericalAttrStats, attr.list=2,3, "
        f"cond.attr.ord=7), every output equal to its standalone run: cold "
        f"{times['cold']:.3f} s (tees the cache), warm {times['warm']:.3f} "
        f"s, K1 {k['cold'][0]} / {k['warm'][0]}, K2 0; cpu "
        f"{times['cpu']:.3f} s; killed ({died}) after the sidecar of chunk "
        f"{ck['chunk_index']}, resumed in {t_resume:.3f} s with "
        f"{histogram.K1_LAUNCHES} K1 launches [{card}]")

    for mesh in (make_mesh([cuda0]), make_mesh([cuda0] * 4)):
        t = time.perf_counter()
        reps = algebra.run_dynamic(mesh=mesh)
        bad = [r.format() for r in reps if r.failed or r.withdrawn]
        if bad or len(reps) < 6 * len(algebra.DEFAULT_SEEDS):
            raise AssertionError(f"fold certificate on {mesh!r}: {bad}")
        log(f"fold certificate (algebra.run_dynamic) on {mesh!r}: "
            f"{len(reps)} reports clean in {time.perf_counter() - t:.3f} s")

    # K1 at the fused pass's chunk: NB's fold of the first chunk (int32,
    # the caps the spec sizes from it)
    with open(os.path.join(inp, "part-00000"), "rb") as fh:
        buf = fh.read()
    enc = DatasetEncoder(FeatureSchema.from_file(schema))
    x, _, y, n = enc.encode_buffer_chunk(
        buf[:pipeline.row_chunk_ends(buf, SHARED_CHUNK)[0]], ",")
    st = _NBStreamState(enc)
    st.size_caps(x)
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    case = ("K1fused", "fused shared-scan chunk (bench.py:840 cell)",
            st.n_class_cap, st.bins_cap, None,
            lambda: (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(),
                     None))
    return {"K1fused": k_fused[0]}, case


def tree_runbooks(work: str, dev: str) -> dict:
    """``resource/decision_tree`` (three levels) and
    ``resource/retarget_tree`` through the command line; every file they
    write."""
    from avenir_tpu_torch import datagen

    dv = ["--device", dev]
    with in_dir(work):
        shutil.copy(os.path.join(DTB_BOOK, "retarget.json"), work)
        datagen.main(["retarget", "2000", "--seed", "31",
                      "--out", "work/lvl0in/part-00000"])
        src = "work/lvl0in"
        for lvl in range(3):
            run_job(["DecisionTreeBuilder",
                     f"-Dconf.path={DTB_BOOK}/dtb.properties", src,
                     f"work/lvl{lvl + 1}"] + dv)
            src = f"work/lvl{lvl + 1}"
        node = "work/campaign/split=root/data"
        datagen.main(["retarget", "4000", "--seed", "31",
                      "--out", f"{node}/partition.txt"])
        run_job(["ClassPartitionGenerator",
                 f"-Dconf.path={RT_BOOK}/root.properties", node,
                 "work/rootout"] + dv)
        with open("work/rootout/part-r-00000") as fh:
            parent = fh.readline().strip()
        run_job(["SplitGenerator", f"-Dconf.path={RT_BOOK}/splitgen.properties",
                 f"-Dparent.info={parent}", "-", "-"] + dv)
        run_job(["DataPartitioner", f"-Dconf.path={RT_BOOK}/dp.properties",
                 "-", "-"] + dv)
        return dir_bytes("work")


def write_retarget(n: int, seed: int) -> bytes:
    """``n`` rows of the retarget generator's distribution
    (``datagen.gen_retarget``: customer id, one of nine retarget types,
    cart amount 20-320, converted at the type's planted rate), drawn in
    bulk."""
    import numpy as np

    from avenir_tpu_torch.datagen import RETARGET_CONVERSION

    rng = np.random.default_rng(seed)
    types = np.asarray(list(RETARGET_CONVERSION))
    rate = np.asarray(list(RETARGET_CONVERSION.values()))
    cust = 1_000_000 + rng.integers(0, 1_000_000, n)
    t = rng.integers(0, 9, n)
    conv = np.where(rng.integers(1, 101, n) < rate[t], "Y", "N")
    amount = 20 + rng.integers(0, 301, n)
    return "".join(f"{c},{ty},{a},{v}\n" for c, ty, a, v in
                   zip(cust.tolist(), types[t].tolist(), amount.tolist(),
                       conv.tolist())).encode()


def level_pass(torch, card) -> None:
    """bench.py:1327's level pass at full width: the (path, predicate,
    class) count over 2,000,000 rows x 64 predicates x 8 paths x 2
    classes on the card, its first 200,000 rows against the port's CPU
    answer, and its total against the closed form (every row counts once
    per satisfied predicate)."""
    from avenir_tpu_torch.models.tree import _path_pred_class_count_local

    g = torch.Generator(device="cuda").manual_seed(0)
    path_id = torch.randint(0, LEVEL_PATHS, (LEVEL_N,), generator=g,
                            device="cuda", dtype=torch.int32)
    y = torch.randint(0, LEVEL_CLASSES, (LEVEL_N,), generator=g,
                      device="cuda", dtype=torch.int32)
    bmat = torch.rand((LEVEL_N, LEVEL_PREDS), generator=g,
                      device="cuda") < 0.5
    args = (LEVEL_PATHS, LEVEL_PREDS, LEVEL_CLASSES)
    run = lambda: _path_pred_class_count_local(path_id, y, bmat, None, *args)
    got = run()
    if int(got.sum()) != int(bmat.sum()):
        raise AssertionError("the level pass's total is not the closed "
                             "form's")
    m = LEVEL_CPU_ROWS
    part = _path_pred_class_count_local(path_id[:m], y[:m], bmat[:m], None,
                                        *args)
    cpu = _path_pred_class_count_local(path_id[:m].cpu(), y[:m].cpu(),
                                       bmat[:m].cpu(), None, *args)
    if not torch.equal(part.cpu(), cpu):
        raise AssertionError("the level pass's first 200,000 rows differ "
                             "from the CPU's")
    ms = time_ms(run, 5)
    try:
        device = f"{kernel_device_ms(run, 3, 'index'):.4f} ms"
    except AssertionError:
        device = "not measured (the profiler kept no index_add_ event)"
    log(f"tree level pass (bench.py:1327, {LEVEL_N} x {LEVEL_PREDS} "
        f"predicates x {LEVEL_PATHS} paths x {LEVEL_CLASSES} classes, "
        f"count_table): call {ms:.4f} ms ({LEVEL_N / ms * 1e3:.0f} rows/s), "
        f"index_add_ device {device}; total = closed form, first {m} rows "
        f"= CPU [{card}]")
    by_kind, wall_s = profile_device(torch, lambda: [run() for _ in range(3)],
                                     {"count (index_add_)": "index"})
    report_phase("tree level pass x3", by_kind, wall_s, "count (index_add_)",
                 card)
    del path_id, y, bmat, got
    torch.cuda.empty_cache()


def tree_streamed(torch, card) -> None:
    """``DecisionTreeBuilder`` streamed over 1,000,000 retarget rows: the
    runbook's configuration with ``cartAmount`` the only feature (a level
    split on ``retargetType`` writes each row once for every satisfied
    predicate of its 255 two-group partitions), the root level on the
    card, then the first level streamed in 65,536-row chunks on the card
    and on the CPU from the same root: the decision file and the level's
    records byte-equal."""
    w = os.path.join(WORK, "tree_stream")
    os.makedirs(w)
    t = time.perf_counter()
    inp = write_part(os.path.join(w, "in"),
                     write_retarget(DTB_STREAM_ROWS, 31))
    with open(os.path.join(DTB_BOOK, "retarget.json")) as fh:
        schema = json.load(fh)
    schema["fields"][1]["feature"] = False
    spath = os.path.join(w, "retarget_amount.json")
    with open(spath, "w") as fh:
        json.dump(schema, fh)
    gen_s = time.perf_counter() - t
    argv = ["DecisionTreeBuilder", f"-Dconf.path={DTB_BOOK}/dtb.properties",
            f"-Dfeature.schema.file.path={spath}",
            f"-Dpipeline.chunk.rows={DTB_STREAM_CHUNK}"]
    root_dec = os.path.join(w, "root.json")
    t = time.perf_counter()
    run_job(argv + [f"-Ddecision.file.path={root_dec}", inp,
                    os.path.join(w, "root"), "--device", "cuda"])
    root_s = time.perf_counter() - t
    got, secs, text = {}, {}, {}
    for dev in ("cuda", "cpu"):
        dec = os.path.join(w, f"{dev}.json")
        shutil.copy(root_dec, dec)
        out = os.path.join(w, f"level1_{dev}")

        def level():
            text[dev] = run_job(argv + [f"-Ddecision.file.path={dec}",
                                        os.path.join(w, "root"), out,
                                        "--device", dev])
        t = time.perf_counter()
        if dev == "cuda":       # the card's run is the profiled one
            by_kind, wall_s = profile_device(
                torch, level, {"count (index_add_)": "index"})
        else:
            level()
        secs[dev] = time.perf_counter() - t
        got[dev] = (open(dec, "rb").read(), read_bytes(out))
    lines = counter(text["cuda"], "Stats", "output records")
    if got["cuda"] != got["cpu"]:
        raise AssertionError("the streamed level's card and CPU outputs "
                             "differ")
    log(f"DecisionTreeBuilder streamed over {DTB_STREAM_ROWS} rows (data "
        f"{gen_s:.3f} s): root level on cuda {root_s:.3f} s; first level "
        f"in {DTB_STREAM_CHUNK}-row chunks cuda {secs['cuda']:.3f} s "
        f"({DTB_STREAM_ROWS / secs['cuda']:.0f} rows/s), cpu "
        f"{secs['cpu']:.3f} s; {lines} records out; decision file and "
        f"records byte-equal [{card}]")
    report_phase("streamed tree level", by_kind, wall_s,
                 "count (index_add_)", card)


def serve_tree(torch, card, decpath: str) -> None:
    """``python -m avenir_tpu_torch serve`` with the decision_tree
    runbook's tree as a ``decisionTree`` model (two replicas on cuda:0,
    batches to 64): 200 fresh retarget rows from 16 single-row clients,
    then batch requests of 1-64 rows; every response equal to the CPU
    route (the adapter on the CPU, in process)."""
    import re
    import signal

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.metrics import Counters
    from avenir_tpu_torch.datagen import gen_retarget
    from avenir_tpu_torch.serve.engine import DecisionTreeAdapter

    w = os.path.join(WORK, "serve_tree")
    os.makedirs(w)
    schema = os.path.join(DTB_BOOK, "retarget.json")
    test = [",".join(r) for r in gen_retarget(TREE_SERVE_ROWS, seed=5)]
    cpu_route = DecisionTreeAdapter(JobConfig({
        "feature.schema.file.path": schema, "decision.file.path": decpath}),
        Counters(), device="cpu")
    want = cpu_route.predict_lines(test)
    if sum(x is not None for x in want) < TREE_SERVE_ROWS // 2:
        raise AssertionError("the tree routes too few of the test rows")
    conf = os.path.join(w, "serve.properties")
    with open(conf, "w") as fh:
        fh.write("serve.models=tree\nserve.model.tree.kind=decisionTree\n"
                 f"serve.model.tree.feature.schema.file.path={schema}\n"
                 f"serve.model.tree.decision.file.path={decpath}\n"
                 "serve.pool.replicas=2\nserve.batch.max.size=64\n"
                 "serve.batch.max.delay.ms=2\nserve.queue.max.depth=256\n")
    log_path = os.path.join(w, "server.log")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t_start = time.perf_counter()
    with open(log_path, "w") as log_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch", "serve",
             f"-Dconf.path={conf}", "-Dserve.port=0"], cwd=w, env=env,
            stdout=log_fh, stderr=subprocess.STDOUT)
    try:
        port = None
        while port is None:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}: "
                                     + open(log_path).read()[-2000:])
            if time.perf_counter() - t_start > 180:
                raise AssertionError("serve did not come up in 180 s")
            m = re.search(r"serving .* on ([\w.]+):(\d+)",
                          open(log_path).read())
            port = int(m.group(2)) if m else None
            time.sleep(0.1)
        up_s = time.perf_counter() - t_start
        stats = request(port, {"cmd": "stats"})
        devices = [r["device"] for v in
                   stats["models"]["tree"]["variants"].values()
                   for r in v["replicas"]]
        if devices != ["cuda:0"] * 2:
            raise AssertionError(f"tree replicas on {devices}")
        t = time.perf_counter()
        outs, lat = fan_out(lambda i: request(port, {
            "model": "tree", "row": test[i]}), list(range(len(test))))
        single_s = time.perf_counter() - t
        bad = [i for i, o in enumerate(outs)
               if o.get("output") != want[i]
               or (want[i] is None) != ("error" in o)]
        if bad:
            raise AssertionError(f"{len(bad)} single-row tree responses "
                                 f"differ from the CPU route: {outs[bad[0]]}")
        lo, n_rows, t = 0, 0, time.perf_counter()
        for size in SERVE_BATCH_SIZES:
            resp = request(port, {"model": "tree", "rows": test[lo:lo + size]})
            if resp.get("outputs") != want[lo:lo + size]:
                raise AssertionError(f"a {size}-row tree response differs "
                                     f"from the CPU route")
            lo, n_rows = lo + size, n_rows + size
        batch_s = time.perf_counter() - t
        lat_ms = request(port, {"cmd": "stats"})["models"]["tree"][
            "latency_ms"]
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"serve exited {rc} on SIGINT: "
                             + open(log_path).read()[-2000:])
    p50, p99 = quantiles_ms(lat)
    log(f"serve_tree (CLI, TCP, 2 replicas on cuda:0, host routing over "
        f"{len(cpu_route.dpl.paths)} leaf paths and "
        f"{len(cpu_route._preds)} distinct predicates): up in "
        f"{up_s:.3f} s; {len(test)} single-row requests from "
        f"{SERVE_CLIENTS} clients {len(test) / single_s:.1f} rows/s, client "
        f"p50 {p50:.3f} ms p99 {p99:.3f} ms; stats surface p50 "
        f"{lat_ms.get('p50')} ms p99 {lat_ms.get('p99')} ms; {n_rows} rows "
        f"in {len(SERVE_BATCH_SIZES)} batch requests "
        f"{n_rows / batch_s:.1f} rows/s; every response equal to the CPU "
        f"route [{card}]")


def tree_paths(torch, card) -> None:
    w = os.path.join(WORK, "tree")
    rb, secs = on_both(lambda dev: tree_runbooks(
        os.path.join(w, f"runbook_{dev}"), dev))
    same_on_both("tree runbooks", rb)
    log(f"decision_tree (3 levels) and retarget_tree through the CLI: cuda "
        f"{secs['cuda']:.3f} s, cpu {secs['cpu']:.3f} s; {len(rb['cuda'])} "
        f"files byte-equal (decpath.json, the levels, the split=/segment= "
        f"tree) [{card}]")
    level_pass(torch, card)
    tree_streamed(torch, card)
    serve_tree(torch, card, os.path.join(w, "runbook_cuda", "work",
                                         "decpath.json"))


def write_visits(n: int, seed: int) -> bytes:
    """``n`` rows of the ``visit_history`` preset's distribution (user id,
    a T/F label true to the user's conversion 90% of the time, then 2-20
    session states for converters and 2-12 for the rest, each state an
    elapsed-time and a duration letter skewed by conversion), drawn in
    bulk."""
    import numpy as np

    rng = np.random.default_rng(seed)
    conv = rng.integers(0, 101, n) < 50
    truth = rng.integers(0, 101, n) < 90
    label = np.where(conv == truth, "T", "F")
    n_sess = np.where(conv, rng.integers(2, 21, n), rng.integers(2, 13, n))
    total = int(n_sess.sum())
    cs = np.repeat(conv, n_sess)
    s1, s2 = rng.integers(0, 101, total), rng.integers(0, 101, total)
    el = np.where(cs, np.where(s1 <= 15, "H", np.where(s1 <= 40, "M", "L")),
                  np.where(s1 <= 20, "L", np.where(s1 <= 45, "M", "H")))
    du = np.where(cs, np.where(s2 <= 15, "L", np.where(s2 <= 40, "M", "H")),
                  np.where(s2 <= 20, "H", np.where(s2 <= 45, "M", "L")))
    states = np.char.add(el, du).tolist()
    uid = rng.integers(10 ** 10, 10 ** 11, n).tolist()
    out, lo = [], 0
    for i, k in enumerate(n_sess.tolist()):
        out.append(f"U{uid[i]},{label[i]}," + ",".join(states[lo:lo + k]))
        lo += k
    return ("\n".join(out) + "\n").encode()


def pst_runbook(work: str, dev: str) -> bytes:
    from avenir_tpu_torch import datagen

    with in_dir(work):
        datagen.main(["visit_history", "800", "--seed", "7",
                      "--out", "work/in/part-00000"])
        run_job(["ProbabilisticSuffixTreeGenerator",
                 f"-Dconf.path={PST_BOOK}/pst.properties", "work/in",
                 "work/out", "--device", dev])
        return read_bytes("work/out")


def pst_paths(torch, card) -> None:
    """``resource/visit_pst`` on the card and on the CPU, then 200,000
    visit rows (windows up to 4) on cuda:0, on a mesh of [cuda:0] * 4
    (each position's halo from the next) and on the CPU: byte-equal."""
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.models.pst import ProbabilisticSuffixTreeGenerator
    from avenir_tpu_torch.parallel.mesh import make_mesh

    w = os.path.join(WORK, "pst")
    rb, secs = on_both(lambda dev: pst_runbook(
        os.path.join(w, f"runbook_{dev}"), dev))
    same_on_both("visit_pst runbook", rb)
    log(f"visit_pst runbook through the CLI: cuda {secs['cuda']:.3f} s, cpu "
        f"{secs['cpu']:.3f} s; byte-equal [{card}]")
    t = time.perf_counter()
    inp = write_part(os.path.join(w, "in"), write_visits(PST_ROWS, 7))
    gen_s = time.perf_counter() - t
    props = {"skip.field.count": "2", "class.label.field.ord": "1",
             "max.seq.length": "4"}
    runs = (("cuda:0", "cuda", None),
            ("mesh [cuda:0] * 4", "cuda",
             make_mesh([torch.device("cuda", 0)] * 4)),
            ("cpu", "cpu", None))
    got, secs = {}, {}
    for label, dev, mesh in runs:
        out = os.path.join(w, label.split()[0].replace(":", ""))
        job = ProbabilisticSuffixTreeGenerator(JobConfig(dict(props)),
                                               device=dev)
        t = time.perf_counter()
        counters = job.run(inp, out, mesh=mesh)
        secs[label] = time.perf_counter() - t
        got[label] = read_bytes(out)
        if counters.get("PST", "HostFallbackWindows"):
            raise AssertionError(f"PST {label} fell back to the host")
    if len(set(got.values())) != 1:
        raise AssertionError(f"PST outputs differ: "
                             f"{[k for k in got if got[k] != got['cpu']]}")
    log(f"PST over {PST_ROWS} visit rows (data {gen_s:.3f} s), windows 2-4: "
        + "; ".join(f"{k} {v:.3f} s" for k, v in secs.items())
        + f"; {got['cpu'].count(NL)} lines, all three byte-equal [{card}]")
    by_kind, wall_s = profile_device(torch, lambda: ProbabilisticSuffixTreeGenerator(
        JobConfig(dict(props)), device="cuda").run(
        inp, os.path.join(w, "profiled"),
        mesh=make_mesh([torch.device("cuda", 0)] * 4)),
        {"window count (index_add_)": "index"})
    report_phase("PST on the 4-position mesh", by_kind, wall_s,
                 "window count (index_add_)", card)


def write_texts(n: int, seed: int) -> bytes:
    """``n`` rows of the ``text_classified`` preset's distribution (2-4
    words of the class's sentiment pool and 3-7 neutral words, shuffled;
    the class P or N), drawn in bulk."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = ["excellent", "great", "fantastic", "loved", "wonderful", "superb"]
    neg = ["terrible", "awful", "broken", "refund", "worst", "disappointed"]
    neutral = ["product", "delivery", "box", "ordered", "arrived", "item",
               "week", "store", "price", "color"]
    positive = rng.random(n) < 0.5
    k_sig, k_neu = rng.integers(2, 5, n), rng.integers(3, 8, n)
    sig = rng.integers(0, 6, (n, 4))
    neu = rng.integers(0, 10, (n, 7))
    keys = rng.random((n, 11))
    out = []
    for i in range(n):
        pool = pos if positive[i] else neg
        words = ([pool[j] for j in sig[i, :k_sig[i]]]
                 + [neutral[j] for j in neu[i, :k_neu[i]]])
        order = np.argsort(keys[i, :len(words)])
        out.append(" ".join(words[j] for j in order) + ","
                   + ("P" if positive[i] else "N"))
    return ("\n".join(out) + "\n").encode()


def text_runbooks(work: str, dev: str) -> dict:
    from avenir_tpu_torch import datagen

    dv = ["--device", dev]
    with in_dir(work):
        datagen.main(["text_classified", "500", "--seed", "17",
                      "--out", "work/wc.csv"])
        with open("work/wc.csv", "rb") as fh:
            texts = [line.split(b",")[0] for line in fh.read().splitlines()]
        write_part("work/wcin", NL.join(texts) + NL)
        run_job(["WordCounter", f"-Dconf.path={WC_BOOK}/wc.properties",
                 "work/wcin", "work/words"] + dv)
        datagen.main(["text_classified", "800", "--seed", "17",
                      "--out", "work/all.csv"])
        with open("work/all.csv", "rb") as fh:
            rows = fh.read().splitlines(keepends=True)
        write_part("work/train", b"".join(rows[:600]))
        write_part("work/test", b"".join(rows[-200:]))
        run_job(["BayesianDistribution",
                 f"-Dconf.path={TC_BOOK}/nbtext.properties", "work/train",
                 "work/model"] + dv)
        run_job(["BayesianPredictor", f"-Dconf.path={TC_BOOK}/bptext.properties",
                 "work/test", "work/pred"] + dv)
        return {k: read_bytes(f"work/{k}") for k in ("words", "model", "pred")}


def text_k1_cases(torch, train_dir: str) -> list:
    """K1 at the text mode's shape (F = 1, one bin per token, int32): the
    runbook's own training tokens, and 2,000,000 seeded token ids over a
    40,000-token vocabulary at 2 classes, an 80,000-cell table that takes
    the 2-block cluster route on an H100."""
    import numpy as np

    from avenir_tpu_torch.core.io import read_lines
    from avenir_tpu_torch.models.text import standard_tokenize

    vocab, classes, toks, cls = {}, {}, [], []
    for line in read_lines(train_dir):
        text, label = line.split(",")
        c = classes.setdefault(label, len(classes))
        for tok in standard_tokenize(text):
            toks.append(vocab.setdefault(tok, len(vocab)))
            cls.append(c)
    x = np.asarray(toks, np.int32)[:, None]
    y = np.asarray(cls, np.int32)

    def wide():
        g = torch.Generator(device="cuda").manual_seed(40)
        return (torch.randint(0, TEXT_WIDE_V, (TEXT_WIDE_N, 1), generator=g,
                              device="cuda", dtype=torch.int32),
                torch.randint(0, 2, (TEXT_WIDE_N,), generator=g,
                              device="cuda", dtype=torch.int32), None)

    return [("K1text", "NB text runbook's tokens", len(classes), len(vocab),
             None, lambda: (torch.from_numpy(x).cuda(),
                            torch.from_numpy(y).cuda(), None)),
            ("K1text", "text shape, 40,000-token vocabulary", 2, TEXT_WIDE_V,
             None, wide)]


def text_paths(torch, histogram, card) -> tuple:
    """``resource/word_count`` and ``resource/text_classify`` on the card
    and on the CPU, then 200,000 text rows: NB text training (one K1
    launch, F = 1) on 160,000, scoring the other 40,000, and WordCounter
    over all, card against CPU.  Returns the NB text training's K1
    launches and K1's text-shape cases."""
    w = os.path.join(WORK, "text")
    histogram.reset_launch_counts()
    rb, secs = on_both(lambda dev: text_runbooks(
        os.path.join(w, f"runbook_{dev}"), dev))
    if histogram.K1_LAUNCHES != 1:
        raise AssertionError(f"the text_classify runbook's training "
                             f"launched K1 {histogram.K1_LAUNCHES} times")
    same_on_both("word_count / text_classify runbooks", rb)
    log(f"word_count and text_classify through the CLI: cuda "
        f"{secs['cuda']:.3f} s, cpu {secs['cpu']:.3f} s; "
        f"{len(rb['cuda'])} outputs byte-equal; NB text training's K1 "
        f"launches 1 [{card}]")
    t = time.perf_counter()
    rows = write_texts(TEXT_ROWS, 17).splitlines(keepends=True)
    train = write_part(os.path.join(w, "train"), b"".join(rows[:TEXT_TRAIN]))
    test = write_part(os.path.join(w, "test"), b"".join(rows[TEXT_TRAIN:]))
    texts = write_part(os.path.join(w, "texts"), b"".join(
        r.split(b",")[0] + NL for r in rows))
    gen_s = time.perf_counter() - t

    def steps(dev):
        d = os.path.join(w, dev)
        out, secs = {}, {}
        for label, argv, o in (
                ("NB text train", ["BayesianDistribution",
                                   "-Dtabular.input=false", train], "model"),
                ("NB text score", ["BayesianPredictor", "-Dtabular.input=false",
                                   f"-Dbayesian.model.file.path={d}/model",
                                   "-Dbp.predict.class=N,P", test], "pred"),
                ("WordCounter", ["WordCounter", "-Dtext.field.ordinal=0",
                                 texts], "words")):
            histogram.reset_launch_counts()
            t = time.perf_counter()
            run_job(argv + [os.path.join(d, o), "--device", dev])
            secs[label] = time.perf_counter() - t
            out[o] = read_bytes(os.path.join(d, o))
            if dev == "cuda" and label == "NB text train":
                out["k1"] = histogram.K1_LAUNCHES
        return out, secs

    got, secs = {}, {}
    for dev in ("cuda", "cpu"):
        got[dev], secs[dev] = steps(dev)
    k1 = got["cuda"].pop("k1")
    if k1 != 1:
        raise AssertionError(f"NB text training launched K1 {k1} times")
    same_on_both("text at 200,000 rows", got)
    log(f"text at {TEXT_ROWS} rows (data {gen_s:.3f} s): " + "; ".join(
        f"{label} cuda {secs['cuda'][label]:.3f} s cpu "
        f"{secs['cpu'][label]:.3f} s" for label in secs["cuda"])
        + f"; byte-equal; K1 launches in training {k1} [{card}]")
    by_kind, wall_s = profile_device(torch, lambda: run_job([
        "BayesianDistribution", "-Dtabular.input=false", train,
        os.path.join(w, "profiled"), "--device", "cuda"]),
        {"histogram kernel": "histogram_kernel"})
    report_phase(f"NB text training ({TEXT_TRAIN} rows)", by_kind, wall_s,
                 "histogram kernel", card)
    return {"K1text": k1}, text_k1_cases(
        torch, os.path.join(w, "runbook_cuda", "work", "train"))


def lr_loop(work: str, dev: str) -> tuple:
    """``resource/logistic_regression/run.sh``'s loop in process: each
    iteration one ``LogisticRegressionJob`` through the command line,
    exit status 100 converged, 101 not yet; (iterations, history)."""
    from avenir_tpu_torch.cli import main as cli_main

    with in_dir(work):
        shutil.copy(os.path.join(LR_BOOK, "lr.json"), work)
        rows = subprocess.run([sys.executable, os.path.join(LR_BOOK, "gen.py"),
                               "2000"], capture_output=True, check=True
                              ).stdout
        write_part("work/in", rows)
        with open("work/coeff.txt", "w") as fh:
            fh.write("0.0,0.0,0.0,0.0,0.0\n")
        for it in range(1, 61):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli_main(["LogisticRegressionJob",
                               f"-Dconf.path={LR_BOOK}/lr.properties",
                               "work/in", "work/out", "--device", dev])
            if rc == 100:
                break
            if rc != 101:
                raise AssertionError(f"LR exited {rc}: {err.getvalue()}")
        else:
            raise AssertionError("the LR runbook did not converge")
        with open("work/coeff.txt") as fh:
            return it, [[float(v) for v in line.split(",")]
                        for line in fh.read().splitlines()]


def write_lr_rows(n: int) -> bytes:
    """``resource/logistic_regression/gen.py``'s ``n`` rows, drawn from
    its seed in one call and formatted in bulk: the same bytes as the
    script prints, without its per-row ``print``."""
    import numpy as np

    rng = np.random.default_rng(11)
    feats = rng.integers(-10, 11, (n, 4))
    y = feats[:, 0] + 2 * feats[:, 1] - feats[:, 2] > 0
    return "".join(f"R{i:06d},{a},{b},{c},{d},{'C1' if p else 'C0'}\n"
                   for i, ((a, b, c, d), p) in enumerate(
                       zip(feats.tolist(), y.tolist()))).encode()


def regress_paths(torch, card) -> None:
    """The logistic_regression runbook's loop on the card and on the CPU
    (the same iteration, histories within rtol 1e-9), then gen.py's rows
    at 1,000,000 (written in bulk) for 10 iterations on one resident
    batch, card against CPU, with the seconds per iteration."""
    import numpy as np

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.models.regress import LogisticRegressionJob

    w = os.path.join(WORK, "regress")
    rb, secs = on_both(lambda dev: lr_loop(os.path.join(w, f"rb_{dev}"), dev))
    if rb["cuda"][0] != rb["cpu"][0] or len(rb["cuda"][1]) != len(
            rb["cpu"][1]):
        raise AssertionError(f"LR converged at iteration {rb['cuda'][0]} on "
                             f"the card, {rb['cpu'][0]} on the CPU")
    np.testing.assert_allclose(rb["cuda"][1], rb["cpu"][1], rtol=LR_RTOL)
    log(f"logistic_regression runbook through the CLI: converged at "
        f"iteration {rb['cuda'][0]} on both, {len(rb['cuda'][1])} history "
        f"lines within rtol {LR_RTOL}; cuda {secs['cuda']:.3f} s, cpu "
        f"{secs['cpu']:.3f} s [{card}]")
    t = time.perf_counter()
    rows = write_lr_rows(LR_ROWS)
    with open(os.path.join(w, "rb_cuda", "work", "in", "part-00000"),
              "rb") as fh:
        if not rows.startswith(fh.read()):    # gen.py's own 2,000 rows
            raise AssertionError("the bulk writer's rows are not gen.py's")
    inp = write_part(os.path.join(w, "big"), rows)
    gen_s = time.perf_counter() - t
    hist, it_s, load_s = {}, {}, {}
    for dev in ("cuda", "cpu"):
        coeff = os.path.join(w, f"coeff_{dev}.txt")
        with open(coeff, "w") as fh:
            fh.write("0.0,0.0,0.0,0.0,0.0\n")
        job = LogisticRegressionJob(JobConfig({
            "feature.schema.file.path": os.path.join(LR_BOOK, "lr.json"),
            "coeff.file.path": coeff, "positive.class.value": "C1",
            "learning.rate": "0.3", "iteration.limit": str(LR_ITERS + 1)}),
            device=dev)
        t = time.perf_counter()
        job.run(inp, os.path.join(w, f"out_{dev}"))   # parses the batch
        load_s[dev] = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(LR_ITERS - 1):
            job.run(inp, os.path.join(w, f"out_{dev}"))
        it_s[dev] = (time.perf_counter() - t) / (LR_ITERS - 1)
        with open(coeff) as fh:
            hist[dev] = [[float(v) for v in line.split(",")]
                         for line in fh.read().splitlines()]
        if dev == "cuda":
            by_kind, wall_s = profile_device(torch, lambda: job.run(
                inp, os.path.join(w, "out_profiled")),
                {"float64 products": "gemm", "split-K reduce": "splitK"})
    np.testing.assert_allclose(hist["cuda"], hist["cpu"], rtol=LR_RTOL)
    log(f"LR over {LR_ROWS} gen.py rows (data {gen_s:.3f} s), "
        f"{LR_ITERS} iterations: first (parse + move) cuda "
        f"{load_s['cuda']:.3f} s cpu {load_s['cpu']:.3f} s; then "
        f"{it_s['cuda']:.4f} s an iteration on cuda, {it_s['cpu']:.4f} s on "
        f"the CPU; histories within rtol {LR_RTOL} [{card}]")
    report_phase(f"LR iteration ({LR_ROWS} rows, resident)", by_kind, wall_s,
                 "float64 products", card)


# ---------------------------------------------------------------------------
# dag_paths: the workflow DAG (core/dag.py) on the shared scan
# ---------------------------------------------------------------------------

WORKFLOW_BOOK = os.path.join(ROOT, "resource", "workflow")
WORKFLOW_STAGES = ("bin", "nb", "mi", "corr", "select", "retrain",
                   "validate", "publish")
# bench.py:938's cell: 50,000 churn rows (seed 7) repeated 8 times, the
# all-binned schema, 65,536-row chunks, depth 2, six stages
DAG_BASE_ROWS, DAG_SEED, DAG_REPS = 50_000, 7, 2
DAG_STAGES = ("bin", "nb", "mi", "corr", "select", "retrain")


def stage_bytes(base: str, sids) -> dict:
    """Each stage's output: the part file, or the bare file (select)."""
    out = {}
    for sid in sids:
        p = os.path.join(base, sid)
        out[sid] = (open(p, "rb").read() if os.path.isfile(p)
                    else read_bytes(p))
    return out


def handoffs(text: str) -> int:
    """The ``Memory handoffs`` count of a ``dag`` run's log."""
    import re
    (n,) = re.findall(r"(\d+) in-memory artifact reads", text)
    return int(n)


def workflow_runbook(work: str, dev: str, extra=()) -> tuple:
    """``resource/workflow/run.sh``'s steps through ``python -m
    avenir_tpu_torch dag`` at its own size (250,000 churn rows, seed 29,
    split 200,000 / 50,000); every stage's bytes and the run's log."""
    from avenir_tpu_torch import datagen

    with in_dir(work):
        for f in ("workflow.properties", "teleComChurnBinned.json"):
            shutil.copy(os.path.join(WORKFLOW_BOOK, f), work)
        if not os.path.exists("work/train/part-00000"):
            datagen.main(["telecom_churn", "250000", "--seed", "29",
                          "--out", "work/all.csv"])
            with open("work/all.csv", "rb") as fh:
                lines = fh.read().splitlines(keepends=True)
            write_part("work/train", b"".join(lines[:200_000]))
            write_part("work/test", b"".join(lines[-50_000:]))
        err = run_job(["dag", "-Dconf.path=workflow.properties",
                       "work/train", "work/out", "--device", dev]
                      + list(extra))
        return stage_bytes("work/out", WORKFLOW_STAGES), err


def dag_cell_manifest(schema: str) -> dict:
    """bench.py:938's six-stage manifest."""
    j = {"workflow.stages": ",".join(DAG_STAGES),
         "pipeline.chunk.rows": str(SHARED_CHUNK),
         "pipeline.prefetch.depth": "2",
         "workflow.stage.bin.class": "org.chombo.mr.Projection",
         "workflow.stage.bin.projection.operation": "project",
         "workflow.stage.bin.projection.field": "0,1,2,3,4,5,6,7",
         "workflow.stage.select.class": "FeatureSelect",
         "workflow.stage.select.input": "mi",
         "workflow.stage.select.select.schema.file.path": schema,
         "workflow.stage.select.select.top.features": "4",
         "workflow.stage.retrain.class": "BayesianDistribution",
         "workflow.stage.retrain.input": "bin",
         "workflow.stage.retrain.feature.schema.file.path": "@select"}
    for sid, cls, props in SHARED_JOBS[:3]:
        j[f"workflow.stage.{sid}.class"] = cls
        j[f"workflow.stage.{sid}.input"] = "bin"
        j[f"workflow.stage.{sid}.feature.schema.file.path"] = schema
        j.update({f"workflow.stage.{sid}.{k}": v for k, v in props.items()})
    return j


def dag_chain(torch, inp: str, schema: str, base: str) -> None:
    """The cell as the reference's runbooks chain it: one job at a time
    on the card, every intermediate through its text file."""
    from avenir_tpu_torch.cli import job_class, resolve
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.dag import FeatureSelect

    pipe = {"pipeline.chunk.rows": str(SHARED_CHUNK),
            "pipeline.prefetch.depth": "2"}
    j = os.path.join

    def run(cls, props, src, out):
        job_class(cls)(JobConfig(dict(props, **pipe), resolve(cls)[2]),
                       device="cuda").run(src, j(base, out))

    run("org.chombo.mr.Projection", {"projection.operation": "project",
                                     "projection.field": "0,1,2,3,4,5,6,7"},
        inp, "bin")
    for sid, cls, props in SHARED_JOBS[:3]:
        run(cls, dict(props, **{"feature.schema.file.path": schema}),
            j(base, "bin"), sid)
    FeatureSelect(JobConfig({"select.schema.file.path": schema,
                             "select.top.features": "4"})).run(
        j(base, "mi"), j(base, "select"))
    run("BayesianDistribution",
        {"feature.schema.file.path": j(base, "select")}, j(base, "bin"),
        "retrain")
    torch.cuda.synchronize()


def dag_paths(torch, histogram, card) -> tuple:
    """The workflow DAG on the card: ``resource/workflow/run.sh`` through
    ``python -m avenir_tpu_torch dag`` on cuda:0 and on the CPU (eight
    outputs equal, publish == retrain, the cost model's line, the
    handoffs, K1 13 + 13 + 13); bench.py:938's cell on cuda:0, the DAG
    against the standalone chain with file handoff (byte parity first,
    then the best of 2 each, host clock), K1's launches in the fused group
    and the cell (7 + 7, then 7), the fused group's H2D copies a chunk,
    the device idle share and the handoffs; the runbook's workflow killed
    by ``worker_death@5`` inside the fused group and resumed with
    ``--resume``.  Returns the cell's K1 launches and K1's case at the
    retrain stage's chunk."""
    import numpy as np

    from avenir_tpu_torch.cli import job_resolver
    from avenir_tpu_torch.core import obs, pipeline
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.dag import run_workflow
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.datagen import gen_telecom_churn
    from avenir_tpu_torch.models.bayesian import _NBStreamState
    from avenir_tpu_torch.parallel.mesh import make_mesh

    w = os.path.join(WORK, "dag")
    cuda0 = torch.device("cuda", 0)
    rb, secs, logs, k1 = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        histogram.reset_launch_counts()
        t = time.perf_counter()
        rb[dev], logs[dev] = workflow_runbook(
            os.path.join(w, f"runbook_{dev}"), dev)
        secs[dev] = time.perf_counter() - t
        k1[dev] = histogram.K1_LAUNCHES
    same_on_both("workflow runbook", rb)
    if rb["cuda"]["publish"] != rb["cuda"]["retrain"]:
        raise AssertionError("workflow runbook: publish != retrain")
    decision = [l for l in logs["cuda"].splitlines() if "cost model" in l]
    if (len(decision) != 1 or "[nb,mi,corr]" not in decision[0]
            or "FUSE into one shared scan" not in decision[0]):
        raise AssertionError(f"workflow runbook's cost model: {decision}")
    n_rb = -(-200_000 // 16_384)
    if (k1["cuda"], k1["cpu"]) != (3 * n_rb, 0):
        raise AssertionError(f"workflow runbook's K1 launches {k1}, not "
                             f"{3 * n_rb} on the card and 0 on the CPU")
    if handoffs(logs["cuda"]) != handoffs(logs["cpu"]):
        raise AssertionError("workflow runbook: handoff counts differ")
    log(f"workflow runbook (250,000 rows, 8 stages) through python -m "
        f"avenir_tpu_torch dag: cuda {secs['cuda']:.3f} s, cpu "
        f"{secs['cpu']:.3f} s (datagen included in the first); 8 outputs "
        f"byte-equal, publish == retrain; {decision[0]}; memory handoffs "
        f"{handoffs(logs['cuda'])}; K1 launches {k1['cuda']} = 3 x {n_rb} "
        f"[{card}]")

    # bench.py:938's cell
    base = "".join(",".join(r) + "\n" for r in gen_telecom_churn(
        DAG_BASE_ROWS, seed=DAG_SEED))
    inp = write_part(os.path.join(w, "cell_in"),
                     (base * (SHARED_ROWS // DAG_BASE_ROWS)).encode())
    schema = os.path.join(w, "cell.json")
    with open(schema, "w") as fh:
        json.dump(SHARED_SCAN_SCHEMA, fh)
    cfg = dag_cell_manifest(schema)
    n_chunks = -(-SHARED_ROWS // SHARED_CHUNK)
    tr = obs.get_tracer()
    mark = {}

    def run_dag(out, record=False):
        def say(msg):
            if "cost model" in msg:
                mark["decision"] = msg
            elif "workflow complete" in msg:
                mark["handoffs"] = handoffs(msg)
            elif record and "running stage 'select'" in msg:
                # the fused group is done: its launches and copies
                mark["k1_group"] = histogram.K1_LAUNCHES
                mark["copies"] = len(tr.spans("ingest.h2d"))
                mark["chunks"] = sum(
                    1 for g in tr.records() if isinstance(g, obs.Gauge)
                    and g.name == "multiscan.fanout.width")
        run_workflow(JobConfig(dict(cfg)), inp, out, job_resolver(cuda0),
                     mesh=make_mesh([cuda0]), log=say)
        torch.cuda.synchronize()

    dag_chain(torch, inp, schema, os.path.join(w, "chain"))
    histogram.reset_launch_counts()
    obs.configure(enabled=True)
    tr.clear()
    run_dag(os.path.join(w, "cell_dag"), record=True)
    obs.configure(enabled=False)
    tr.clear()
    k1_cell = histogram.K1_LAUNCHES
    chain = stage_bytes(os.path.join(w, "chain"), DAG_STAGES)
    dag = stage_bytes(os.path.join(w, "cell_dag"), DAG_STAGES)
    bad = [sid for sid in DAG_STAGES if dag[sid] != chain[sid]]
    if bad:
        raise AssertionError(f"DAG cell: {bad} differ from the chain")
    if "FUSE into one shared scan" not in mark["decision"]:
        raise AssertionError(f"DAG cell's cost model: {mark['decision']}")
    if (mark["k1_group"], k1_cell) != (2 * n_chunks, 3 * n_chunks):
        raise AssertionError(f"DAG cell's K1 launches: fused group "
                             f"{mark['k1_group']}, cell {k1_cell}; want "
                             f"{2 * n_chunks}, {3 * n_chunks}")
    if (mark["chunks"], mark["copies"]) != (n_chunks, 2 * n_chunks):
        raise AssertionError(f"DAG cell: {mark['copies']} copies over "
                             f"{mark['chunks']} fused chunks")
    t_dag, t_chain = [], []
    for rep in range(DAG_REPS):
        t = time.perf_counter()
        dag_chain(torch, inp, schema, os.path.join(w, "chain"))
        t_chain.append(time.perf_counter() - t)
        t = time.perf_counter()
        run_dag(os.path.join(w, "cell_dag"))
        t_dag.append(time.perf_counter() - t)
    if stage_bytes(os.path.join(w, "cell_dag"), DAG_STAGES) != chain:
        raise AssertionError("DAG cell: a timed run changed its bytes")
    log(f"DAG cell (bench.py:938: {SHARED_ROWS} rows, {SHARED_CHUNK}-row "
        f"chunks, depth 2, stages {','.join(DAG_STAGES)}, best of "
        f"{DAG_REPS}): DAG {min(t_dag):.3f} s (runs "
        f"{', '.join(f'{x:.3f}' for x in t_dag)}), chain with file handoff "
        f"{min(t_chain):.3f} s (runs {', '.join(f'{x:.3f}' for x in t_chain)}"
        f"); DAG / chain {min(t_dag) / min(t_chain):.4f}; 6 outputs "
        f"byte-equal; {mark['decision']}; K1 launches fused group "
        f"{mark['k1_group']}, cell {k1_cell}; H2D copies a fused chunk "
        f"{mark['copies'] / mark['chunks']:.2f} ({mark['copies']} over "
        f"{mark['chunks']}); memory handoffs {mark['handoffs']} [{card}]")
    by_kind, wall_s = profile_device(
        torch, lambda: run_dag(os.path.join(w, "cell_profiled")),
        {"histogram kernel": "histogram_kernel", "pair count": "index"})
    report_phase("DAG cell", by_kind, wall_s, "histogram kernel", card)

    # kill inside the fused group, then --resume
    book = os.path.join(w, "runbook_cuda")
    killed = ["-Dfault.inject.plan=worker_death@5"]
    with in_dir(book):
        shutil.rmtree("work/out", ignore_errors=True)
    try:
        workflow_runbook(book, "cuda", killed)
    except RuntimeError as e:
        died = str(e)
    else:
        raise AssertionError("worker_death@5 did not kill the workflow")
    out = os.path.join(book, "work", "out")
    for f in ("_workflow.ckpt", "_dag_scan_corr+mi+nb.ckpt"):
        if not os.path.exists(os.path.join(out, f)):
            raise AssertionError(f"the killed workflow left no {f}")
    histogram.reset_launch_counts()
    t = time.perf_counter()
    resumed, err = workflow_runbook(book, "cuda", ["--resume"])
    t_resume = time.perf_counter() - t
    if "skipping completed stage 'bin'" not in err:
        raise AssertionError(f"the resume did not skip bin: {err}")
    if "resuming from" not in err or "byte offset" not in err:
        raise AssertionError(f"the fused scan did not resume mid-scan: "
                             f"{err}")
    if resumed != rb["cuda"]:
        bad = [s for s in WORKFLOW_STAGES if resumed[s] != rb["cuda"][s]]
        raise AssertionError(f"the resumed workflow's {bad} differ")
    if [f for f in os.listdir(out) if f.endswith(".ckpt")]:
        raise AssertionError("the resumed workflow left a sidecar")
    log(f"workflow runbook killed ({died}) inside the fused group, resumed "
        f"in {t_resume:.3f} s with {histogram.K1_LAUNCHES} K1 launches: bin "
        f"skipped, the shared scan resumed mid-file, 8 outputs equal to the "
        f"uninterrupted run [{card}]")

    # K1 at the retrain stage's chunk: NB over the 4 selected features
    sel = FeatureSchema.from_file(os.path.join(w, "cell_dag", "select"))
    enc = DatasetEncoder(sel)
    with open(os.path.join(w, "cell_dag", "bin", "part-r-00000"), "rb") as fh:
        buf = fh.read()
    x, _, y, _ = enc.encode_buffer_chunk(
        buf[:pipeline.row_chunk_ends(buf, SHARED_CHUNK)[0]], ",")
    st = _NBStreamState(enc)
    st.size_caps(x)
    x, y = np.ascontiguousarray(x), np.ascontiguousarray(y)
    case = ("K1dag", "the DAG's retrain chunk (bench.py:938 cell, NB over "
            "the 4 selected features)", st.n_class_cap, st.bins_cap, None,
            lambda: (torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(),
                     None))
    return {"K1dag": k1_cell}, case


# ---------------------------------------------------------------------------
# host_jobs: the batch jobs of queue 1 item 3 and the feedback fold
# ---------------------------------------------------------------------------

HOST_RUNBOOKS = ("class_balance", "event_burst", "event_seq_gsp",
                 "bandit_variants", "price_optimize")
HOST_PARALLEL = 4
FEEDBACK_EVENTS, FEEDBACK_TENANTS, FEEDBACK_ARMS = 1_000_000, 64, 8


def write_feedback_log(path: str) -> str:
    """1M ``tenant,arm,reward`` events (integer rewards 0-999), seeded."""
    import numpy as np

    rng = np.random.default_rng(12)
    t = rng.integers(0, FEEDBACK_TENANTS, FEEDBACK_EVENTS)
    a = rng.integers(0, FEEDBACK_ARMS, FEEDBACK_EVENTS)
    r = rng.integers(0, 1000, FEEDBACK_EVENTS)
    tn = np.char.add("t", np.arange(FEEDBACK_TENANTS).astype(str))
    an = np.char.add("a", np.arange(FEEDBACK_ARMS).astype(str))
    rows = np.char.add(np.char.add(np.char.add(tn[t], ","),
                                   np.char.add(an[a], ",")), r.astype(str))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(rows.tolist()) + "\n")
    return path


def host_jobs(torch, card) -> None:
    """The five runbooks of the batch jobs through the port (each a
    rewritten scratch copy in a subprocess, ``avenir_tpu_torch.runbook``)
    on the card's machine, cuda and CPU, every file of their ``work/``
    equal; ``BanditFeedbackAggregator`` over 1M events on cuda:0 and on
    the CPU (equal bytes, rows/s, the device idle share); ``bandit_fb``'s
    fold certificate on [cuda:0] and [cuda:0] * 4."""
    from avenir_tpu_torch.core import algebra
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.models.bandit import BanditFeedbackAggregator
    from avenir_tpu_torch.parallel.mesh import make_mesh
    from avenir_tpu_torch.runbook import price_optimize_edit, run_runbook

    from concurrent.futures import ThreadPoolExecutor

    w = os.path.join(WORK, "host_jobs")

    def runbook(name, dev):
        edit = price_optimize_edit if name == "price_optimize" else None
        dst = os.path.join(w, f"{name}_{dev}")
        t = time.perf_counter()
        run_runbook(os.path.join(ROOT, "resource", name), dst, device=dev,
                    edit=edit, timeout=600)
        return time.perf_counter() - t, dir_bytes(os.path.join(dst, "work"))

    # the subprocesses spend most of their time starting an interpreter and
    # importing torch, so HOST_PARALLEL of them run at once
    legs = [(name, dev) for name in HOST_RUNBOOKS for dev in ("cuda", "cpu")]
    t = time.perf_counter()
    with ThreadPoolExecutor(HOST_PARALLEL) as pool:
        done = dict(zip(legs, pool.map(lambda leg: runbook(*leg), legs)))
    log(f"the {len(HOST_RUNBOOKS)} runbooks on the card and on the CPU, "
        f"{HOST_PARALLEL} subprocesses at once: {time.perf_counter() - t:.3f}"
        f" s [{card}]")
    for name in HOST_RUNBOOKS:
        outs = {dev: done[(name, dev)][1] for dev in ("cuda", "cpu")}
        same_on_both(f"{name} runbook", outs)
        log(f"{name} runbook through the port: cuda "
            f"{done[(name, 'cuda')][0]:.3f} s, cpu "
            f"{done[(name, 'cpu')][0]:.3f} s; {len(outs['cuda'])} files "
            f"byte-equal [{card}]")

    events = write_feedback_log(os.path.join(w, "feedback", "events.csv"))
    cfg = {"stream.tenants": ",".join(f"t{i}" for i in range(
               FEEDBACK_TENANTS)),
           "stream.arms": ",".join(f"a{i}" for i in range(FEEDBACK_ARMS))}
    outs, secs = {}, {}
    for dev in ("cuda", "cpu", "cuda"):
        out = os.path.join(w, "feedback", f"out_{dev}")
        t = time.perf_counter()
        c = BanditFeedbackAggregator(JobConfig(dict(cfg)), device=dev).run(
            events, out)
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t     # the warm cuda run's kept
        outs[dev] = read_bytes(out)
        if c.get("Stream", "Events folded") != FEEDBACK_EVENTS:
            raise AssertionError(f"feedback fold on {dev}: {c.format()}")
    same_on_both("feedback aggregator", outs)
    by_kind, wall_s = profile_device(
        torch, lambda: BanditFeedbackAggregator(
            JobConfig(dict(cfg)), device="cuda").run(
                events, os.path.join(w, "feedback", "out_profiled")),
        {"index_add": "index"})
    log(f"BanditFeedbackAggregator over {FEEDBACK_EVENTS} events "
        f"({FEEDBACK_TENANTS} tenants x {FEEDBACK_ARMS} arms, 65,536-row "
        f"chunks): cuda {secs['cuda']:.3f} s "
        f"({FEEDBACK_EVENTS / secs['cuda']:.0f} rows/s), cpu "
        f"{secs['cpu']:.3f} s ({FEEDBACK_EVENTS / secs['cpu']:.0f} rows/s); "
        f"posterior lines byte-equal [{card}]")
    report_phase("feedback fold", by_kind, wall_s, "index_add", card)

    cuda0 = torch.device("cuda", 0)
    wd = os.path.join(w, "certificate")
    os.makedirs(wd, exist_ok=True)
    for mesh in (make_mesh([cuda0]), make_mesh([cuda0] * 4)):
        t = time.perf_counter()
        reps = algebra.verify_fold_spec(
            algebra.spec_factory("bandit_fb", wd, cuda0),
            algebra.verification_rows(), mesh, seeds=algebra.DEFAULT_SEEDS,
            spec_name="bandit_fb")
        bad = [r.format() for r in reps if r.failed or r.withdrawn]
        if bad or len(reps) != len(algebra.DEFAULT_SEEDS):
            raise AssertionError(f"bandit_fb's certificate on {mesh!r}: "
                                 f"{bad}")
        log(f"bandit_fb's fold certificate on {mesh!r}: {len(reps)} reports "
            f"clean in {time.perf_counter() - t:.3f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2

    from avenir_tpu_torch.datagen import gen_telecom_churn
    from avenir_tpu_torch.ops import _build, histogram, topk

    try:
        import triton
        triton_info = f"triton {triton.__version__}"
    except ImportError as e:
        triton_info = f"triton not importable ({e})"
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {triton_info}")
    log(f"card: {card}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 matmul is on; the distance engine needs "
                             "full float32 products")

    t0 = time.perf_counter()
    _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s ({_build.sources()})")

    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    train_dir, test_dir = write_churn_data(gen_telecom_churn)

    def histogram_entry(case) -> dict:
        e = run_histogram_case(torch, histogram, *case)
        log(f"{e['name']}: exact; {e['table']}, {e['grid']} blocks; call "
            f"{e['ms']:.4f} ms, device {e['device_ms']:.4f} ms; at one row "
            f"call {e['floor_ms']:.4f} ms, device "
            f"{e['floor_device_ms']:.4f} ms; plain {e['plain_ms']:.4f} ms, "
            f"bincount {e['library_ms']:.4f} ms, bound {e['bound_ms']:.4f} "
            f"ms ({e['bound_by']}) [{card}]")
        return e

    phases = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phases[name] = round(now - t_phase, 1)
        t_phase = now

    # -- kernels against their plain versions -------------------------------
    entries = [histogram_entry(case) for case in
               histogram_cases(torch, main_path_chunk(train_dir))]
    for case in topk_cases(torch):
        entries.append(run_topk_case(torch, topk, *case))
    for nq in K3_SERVING_NQ:      # the kNN server's batches
        entries.append(run_topk_case(
            torch, topk, "serving batch", "euclidean", KNN_K, False, None,
            topk_uniform(torch, nq, KNN_ROWS, KNN_F, 0, 12), kid="K3serve"))
    # the launch floor: one row of one list (16 candidates, one segment)
    floor = run_merge_case(torch, topk, card, 1, "K3merge", "one-row floor",
                           nt=KNN_K)
    entries.append(floor)
    entries.append(run_merge_case(torch, topk, card, floor=floor))
    for nq in K3_SERVING_NQ:      # the merge of a serving batch's segments
        entries.append(run_merge_case(torch, topk, card, nq, "K3mserve",
                                      "serving batch", floor=floor))
        # the keys-out form (a ring hop's) in place at the same lists
        entries.append(run_merge_case(torch, topk, card, nq, "K3mring",
                                      "serving batch", in_place=True,
                                      floor=floor))
    for k in (KNN_K, 64):   # K3's most segments at nq = 1 on this card
        entries.append(run_merge_case(torch, topk, card, 1, "K3merge",
                                      "most segments", nt=SEG_NT, F=SEG_F,
                                      k=k, floor=floor))
    for case in TILE_CASES:     # the mesh engines' tiles
        entries += run_tile_case(torch, topk, card, *case, floor=floor)
    k3_crossover(torch, topk, entries, card)
    phase_done("kernels")

    # -- the main paths, on the card and on the CPU --------------------------
    launches = nb_paths(torch, histogram, train_dir, test_dir, card)
    nb_native_paths(torch, histogram, train_dir, card)
    # K2 at the warm path's own first chunk, from the cache it replayed
    entries.append(histogram_entry(
        main_path_warm_chunk(torch, train_dir, NB_CACHE_CFG)))
    phase_done("nb")
    knn_launches, knn_data = knn_paths(torch, topk, card)
    launches.update(knn_launches)
    phase_done("knn")
    launches.update(mesh_paths(torch, topk, histogram, knn_data, train_dir,
                               card))
    phase_done("mesh")
    serve_nb(torch, card)
    phase_done("serve_nb")
    launches.update(serve_knn(torch, topk, knn_data, card))
    phase_done("serve_knn")
    # the paths without a custom kernel, but the NB runbooks' K1: counts
    # are set to 0 before each and read after it
    nb_runbooks(torch, histogram, card)
    phase_done("nb_runbooks")
    outs = {}
    for path in (apriori_paths, markov_paths):
        histogram.reset_launch_counts()
        topk.reset_launch_counts()
        outs[path] = path(torch, card)
        log(f"{path.__name__} launches: K1 {histogram.K1_LAUNCHES}, K2 "
            f"{histogram.K2_LAUNCHES}, K3 {topk.K3_LAUNCHES}, K3m "
            f"{topk.MERGE_LAUNCHES}")
        phase_done(path.__name__.replace("_paths", ""))
    serve_markov(torch, card, outs[markov_paths])
    phase_done("serve_markov")
    # the count-table family: K1 on the MI and NB text paths (each path
    # sets the counts to 0 before the runs it reads)
    mi_launches, mi_case, shared = mi_corr_paths(torch, histogram, card)
    launches.update(mi_launches)
    phase_done("mi_corr")
    ms_launches, ms_case = multiscan_paths(torch, histogram, card, *shared)
    launches.update(ms_launches)
    phase_done("multiscan")
    tree_paths(torch, card)
    phase_done("tree")
    pst_paths(torch, card)
    phase_done("pst")
    text_launches, text_cases = text_paths(torch, histogram, card)
    launches.update(text_launches)
    phase_done("text")
    regress_paths(torch, card)
    phase_done("regress")
    # the workflow DAG: K1 in the fused group and the retrain stage (the
    # path sets the counts to 0 before the runs it reads)
    dag_launches, dag_case = dag_paths(torch, histogram, card)
    launches.update(dag_launches)
    phase_done("dag_paths")
    host_jobs(torch, card)
    phase_done("host_jobs")
    for case in [mi_case, ms_case] + text_cases + [dag_case]:
        entries.append(histogram_entry(case))
    log(f"main-path launches: {launches}")
    log(f"phase seconds: {phases}")
    for e in entries:
        e["launches"] = launches[e.pop("kid")]

    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
