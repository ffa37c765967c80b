#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``avenir_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``avenir_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version on the card and times both (K3 also over a grid of small
query and candidate counts, the crossover behind the fused engine's
gate), then drives every ported path on the card and again on the CPU:

1. telecom-churn Naive Bayes at the repo's benchmark size (50,000 seeded
   rows repeated to 2,000,000; the first 1.6M train in 131,072-row chunks,
   the last 400k are scored): cold training (kernel K1), the same training
   with the ingest cache on and then warm off the cache (kernel K2, then
   held at the cache's own first chunk), and float64 / float32 scoring,
   with and without ``output.feature.prob.only`` (and each scorer's device
   time with XLA's float math against torch's exp/log);
2. the kNN classification job at the width of the repo's kNN benchmark
   (16,384 training and 16,384 test rows of 256 numeric features,
   ``output.top.matches=16``, kernel K3), then top-16 voting, through
   ``avenir_tpu_torch.cli.main``;
3. the ``resource/knn_classify/run.sh`` sequence at its 120-row size.

Kernel counts are set to 0 just before each path and read just after.
Outputs must be byte-identical between the card and the CPU, except kNN
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
import shutil
import subprocess
import sys
import time

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

BASE_ROWS, TOTAL_ROWS, TRAIN_ROWS = 50_000, 2_000_000, 1_600_000
CHUNK_ROWS = 131_072
NB_CFG = {"feature.schema.file.path": SCHEMA,
          "pipeline.chunk.rows": str(CHUNK_ROWS)}
NB_CACHE_CFG = dict(NB_CFG, **{"ingest.cache.enable": "true",
                               "ingest.cache.dir":
                                   os.path.join(WORK, "ingestcache")})
KNN_ROWS, KNN_F, KNN_K = 16_384, 256, 16
EXACT_CDIST = "donot_use_mm_for_euclid_dist"   # differences, not the expansion


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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
    chunk (its real codes), the whole churn training set and the wide
    table of the reference's wide-count benchmark (bench.py:1427), with
    masks, -1 codes, out-of-range bins and classes; and one table too
    large for a block's shared memory, which takes the kernel's
    global-memory path.  K2's main-path chunk exists only once the cache
    is written (``main_path_warm_chunk``)."""
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

    i8, i32 = torch.int8, torch.int32
    wide_w = tuple(1 + (7 * f) % 40 for f in range(32))
    return [
        ("K1", "main-path chunk 0", C, B, None, real),
        ("K1", "churn", C, B, None, synth(TRAIN_ROWS, F, C, i8, -1, B + 2, 1)),
        ("K1", "wide", 8, 32, None, synth(TOTAL_ROWS, 32, 8, i32, -1, 34, 2)),
        ("K1", "global-memory table", 8, 128, None,
         synth(1 << 18, 64, 8, i32, -1, 130, 3)),
        # the warm path's dtype and widths; raw values past the top bin
        ("K2", "churn", C, B, churn_w,
         synth(TRAIN_ROWS, F, C, i32, -40, B * max(churn_w), 4)),
        ("K2", "wide", 8, 32, wide_w,
         synth(TOTAL_ROWS, 32, 8, i32, -400, 1300, 5)),
    ]


def run_histogram_case(torch, histogram, kid, tag, C, B, widths,
                       make_inputs) -> dict:
    """Hold K1 or K2 against its plain version on the same inputs (exact
    equality: the counts are integers); time the kernel, the plain
    version and ``torch.bincount`` over the composite key; compute the
    bound."""
    x, y, mask = make_inputs()
    n, F = x.shape
    dev = x.device
    if kid == "K1":
        kern = lambda out=None: histogram.wide_feature_class_counts(
            x, y, C, B, mask=mask, out=out)
        plain = lambda: histogram.plain_feature_class_counts(x, y, C, B, mask)
        binned = x.long()
        name = "wide_feature_class_counts"
    else:
        kern = lambda out=None: histogram.wide_feature_class_counts_rawbin(
            x, y, C, B, widths, mask=mask, out=out)
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
    ms = time_ms(torch, lambda: kern(out=acc), 50)
    plain_ms = time_ms(torch, plain, 5)
    library_ms = time_ms(torch, lambda: torch.bincount(
        key, minlength=C * F * B), 20)

    nbytes = (n * F * x.element_size() + n * y.element_size()
              + (n if mask is not None else 0)
              + (4 * F if widths else 0) + 4 * C * F * B)
    # per element: class test, bin test (plus the division for K2), add
    bound_ms, bound_by = bound(nbytes, n * F * (4 if widths else 3))
    dtype = str(x.dtype).replace("torch.", "")
    masked = ", mask" if mask is not None else ""
    del x, y, mask, got, want, binned, key, valid, acc
    torch.cuda.empty_cache()
    return {"name": f"{kid} {name} [{tag}: n={n} F={F} C={C} B={B} "
                    f"{dtype}{masked}]",
            "route": "cuda", "source": COUNT_KERNEL[0],
            "replaces": COUNT_KERNEL[1], "kid": kid,
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
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
    """``(tag, algorithm, k, exact, sample, make)`` for every shape K3 is
    held at.  ``make`` gives weight-folded operands on the card
    ``(qn, qc, tn, tc, cat_w, wsum)``; ``exact`` where the arithmetic is
    exact (integer-valued or duplicated inputs, pure categorical, the
    left-to-right manhattan sum) or the tolerance of bench.py:1136-1156
    applies; ``sample`` compares only the first rows with the plain
    version."""
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
         KNN_K, False, None, uniform(KNN_ROWS, KNN_ROWS, KNN_F, 0, 1)),
        ("mixed numeric + 4 weighted categorical", "euclidean", 9, False,
         None, uniform(4096, 65536, 32, 4, 2, [0.5, 1.0, 1.5, 2.0])),
        ("manhattan", "manhattan", 16, True, None,
         uniform(4096, 16384, 64, 0, 3)),
        ("pure categorical", "euclidean", 5, True, None,
         uniform(4096, 65536, 0, 8, 4, [0.5, 0.75, 1.0, 1.25, 1.5, 1.75,
                                        2.0, 3.0])),
        ("k=64", "euclidean", 64, False, None,
         uniform(2048, KNN_ROWS, KNN_F, 0, 5)),
        ("duplicated candidate rows (ties)", "euclidean", 32, True, None,
         ties),
        ("stride-128 adversarial layout", "euclidean", 8, True, None,
         adversarial),
        ("segmented axis, bench.py:1244", "euclidean", KNN_K, False, 256,
         uniform(2048, 1_050_000, 64, 0, 7)),
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


def run_topk_case(torch, topk, tag, algorithm, k, exact, sample, make
                  ) -> dict:
    """Hold K3 against its plain version, time both and the cross term's
    ``torch.matmul`` (a partial floor: the product alone), and compute
    the bound."""
    qn, qc, tn, tc, cw, wsum = make()
    nq, nt, F, C = qn.shape[0], tn.shape[0], qn.shape[1], qc.shape[1]
    kern = lambda: topk.fused_pairwise_topk(qn, qc, tn, tc, cw, wsum, 1000,
                                            k, algorithm)
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
    ms = time_ms(torch, kern, reps)
    plain_ms = time_ms(torch, plain, reps)
    matmul_ms = (time_ms(torch, lambda: torch.matmul(qn, tn.T), reps)
                 if F and algorithm == "euclidean" and nq * nt <= 1 << 28
                 else None)
    per_pair = (2 if algorithm == "euclidean" else 3) * F + 2 * C
    bound_ms, bound_by = bound(
        4 * ((nq + nt) * (F + C) + C) + 8 * nq * k, per_pair * nq * nt)
    sample_note = f", plain on the first {ns} rows" if sample else ""
    log(f"K3 [{tag}]: nq={nq} nt={nt} F={F} C={C} k={k} {algorithm}: "
        f"max abs err {err}, rows that differ {rows}/{ns}, suspect rows "
        f"{n_suspect}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        f"{sample_note}, bound {bound_ms:.4f} ms ({bound_by}), "
        f"torch.matmul of the cross term alone (partial floor) "
        f"{'n/a' if matmul_ms is None else f'{matmul_ms:.4f} ms'}; "
        f"library: none (no single PyTorch call computes distance + "
        f"exact top-k)")
    del qn, qc, tn, tc, v, i, pv, pi
    torch.cuda.empty_cache()
    return {"name": f"K3 fused_pairwise_topk [{tag}: nq={nq} nt={nt} F={F} "
                    f"C={C} k={k} {algorithm}{sample_note}]",
            "route": "cuda", "source": TOPK_KERNEL[0],
            "replaces": TOPK_KERNEL[1], "kid": "K3",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "matmul_ms": matmul_ms,
            "rows_differ": rows, "suspect_rows": n_suspect}


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
                              topk_uniform(torch, nq, nt, KNN_F, 0, 8))
            entries.append(e)
            ratio[nq, nt] = e["plain_ms"] / e["ms"]
    rows = "; ".join(
        f"nt={nt}: " + ", ".join(f"nq={nq} {ratio[nq, nt]:.2f}x"
                                 for nq in CROSSOVER_NQ)
        for nt in CROSSOVER_NT)
    agree = sum(topk.k3_applicable("euclidean", KNN_K, nq, nt, KNN_F, 0,
                                   "cuda") == (r > 1)
                for (nq, nt), r in ratio.items())
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
                ms[label, prec] = time_ms(torch, lambda: fn(x, values, *tabs),
                                          10)
        finally:
            nb.exp_f64, nb.log_f32, nb.fma_f32 = shipped
    for prec, _ in scorers:
        log(f"NB {prec} scorer device time over {x.shape[0]} rows: "
            f"{ms['XLA float math', prec]:.4f} ms with XLA's float math "
            f"(shipped), {ms['torch exp/log', prec]:.4f} ms with torch's "
            f"exp/log [{card}]")


def nb_breakdown(torch, train_dir: str, base_cfg: dict, card: str) -> None:
    """Where the training time goes: the host encode alone (host clock),
    then one more training run on the card under ``torch.profiler``."""
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import BayesianDistribution

    enc = DatasetEncoder(FeatureSchema.from_file(SCHEMA))
    t = time.perf_counter()
    rows = sum(c[3] for c in enc.encode_path_chunks(train_dir, ",",
                                                     chunk_rows=CHUNK_ROWS))
    encode_s = time.perf_counter() - t
    if rows != TRAIN_ROWS:
        raise AssertionError(f"encoder saw {rows} rows, not {TRAIN_ROWS}")
    by_kind, wall_s = profile_device(
        torch, lambda: BayesianDistribution(
            JobConfig(dict(base_cfg)), device="cuda").run(
            train_dir, os.path.join(WORK, "model_profiled")),
        {"histogram kernel": "histogram_kernel"})
    log(f"train breakdown: host encode alone {encode_s:.3f} s of a "
        f"{wall_s:.3f} s profiled train run [{card}]")
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

    # -- cold training: K1 ------------------------------------------------
    histogram.reset_launch_counts()
    counters, train_s = train("cuda", w("model_cuda"))
    launches = {"K1": histogram.K1_LAUNCHES}
    log(f"NB cold train launches: K1 {histogram.K1_LAUNCHES}, K2 "
        f"{histogram.K2_LAUNCHES}; chunks {counters.get('Ingest', 'Chunks')}")
    if (launches["K1"] != n_chunks or histogram.K2_LAUNCHES
            or counters.get("Ingest", "Chunks") != n_chunks):
        raise AssertionError(f"K1 launched {launches['K1']} times on the "
                             f"cold path; expected one per chunk "
                             f"({n_chunks})")

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
    nb_breakdown(torch, train_dir, base_cfg, card)
    return launches


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


def knn_paths(torch, topk, card) -> dict:
    """The kNN job at full width through the port's command line, on the
    card and on the CPU, then top-16 voting; then the knn_classify
    runbook.  Returns the main-path launches ``{"K3": n}``."""
    d, inp, sim, vote, feats = write_knn_data()

    def job(name, conf, src, out, device):
        t = time.perf_counter()
        text = run_job([name, f"-Dconf.path={conf}", src, out,
                        "--device", device])
        return text, time.perf_counter() - t

    topk.reset_launch_counts()
    text, dist_s = job("SameTypeSimilarity", sim, inp,
                       os.path.join(d, "simi_cuda"), "cuda")
    launches = {"K3": topk.K3_LAUNCHES}
    fused = counter(text, "Distance", "Fused engine calls")
    reresolved = counter(text, "Distance", "Re-resolved rows")
    log(f"kNN distance job launches: K3 {launches['K3']}; fused engine "
        f"calls {fused}; suspect rows re-resolved by the sorted engine "
        f"{reresolved}")
    if launches["K3"] < 1 or launches["K3"] != fused:
        raise AssertionError(f"K3 launched {launches['K3']} times for "
                             f"{fused} fused-engine calls")
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
    return launches


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
        {"K3 kernel": "topk_kernel"})
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
        log(f"{e['name']}: exact; kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bincount {e['library_ms']:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}) [{card}]")
        return e

    # -- kernels against their plain versions -------------------------------
    entries = [histogram_entry(case) for case in
               histogram_cases(torch, main_path_chunk(train_dir))]
    for case in topk_cases(torch):
        entries.append(run_topk_case(torch, topk, *case))
    k3_crossover(torch, topk, entries, card)

    # -- the main paths, on the card and on the CPU --------------------------
    launches = nb_paths(torch, histogram, train_dir, test_dir, card)
    # K2 at the warm path's own first chunk, from the cache it replayed
    entries.append(histogram_entry(
        main_path_warm_chunk(torch, train_dir, NB_CACHE_CFG)))
    launches.update(knn_paths(torch, topk, card))
    log(f"main-path launches: {launches}")
    for e in entries:
        e["launches"] = launches[e.pop("kid")]

    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
