#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``avenir_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``avenir_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card (exact equality:
the counts are integers) and times both, then drives the telecom-churn
Naive Bayes main path at the size of the repo's benchmark (50,000 seeded
rows repeated to 2,000,000; the first 1.6M train in 131,072-row chunks,
the last 400k are scored), on the card and again on the CPU, and checks
that the model file and the float64 predictions are byte-identical and
the float32 predictions keep the port's float32-vs-float64 contract.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is a JSON object with one entry per kernel and shape.
Any failure raises and the script exits non-zero; without a CUDA device it
exits 2 before doing anything.  Work files go to ``build/chip_smoke/``.
"""

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

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12      # float32 outside the tensor cores
PALLAS_KERNEL = "avenir_tpu/ops/pallas_count.py:53"
KERNEL_SOURCE = "avenir_tpu_torch/csrc/histogram.cu"

BASE_ROWS, TOTAL_ROWS, TRAIN_ROWS = 50_000, 2_000_000, 1_600_000
CHUNK_ROWS = 131_072


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


def main_path_chunk(train_dir: str):
    """The first training chunk exactly as the streamed trainer hands it to
    K1 (int8 codes, -1 in the Gaussian column, no mask) and the trainer's
    table extents ``(x, y, n_class, bins)``."""
    from avenir_tpu_torch.core.binning import DatasetEncoder
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models.bayesian import _NBStreamState

    enc = DatasetEncoder(FeatureSchema.from_file(SCHEMA))
    x, values, y, n = next(enc.encode_path_chunks(train_dir, ",",
                                                  chunk_rows=CHUNK_ROWS))
    st = _NBStreamState(enc)
    st.size_caps(x)
    xs, ys = st.accept(x, values, y, n)
    return xs, ys, st.n_class_cap, st.bins_cap


def kernel_cases(torch, chunk):
    """``(kid, tag, C, B, widths, make_inputs)`` for every kernel at every
    shape it is held at: the main path's first chunk (its real codes), the
    whole churn training set and the wide table of the reference's
    wide-count benchmark (bench.py:1427), with masks, -1 codes,
    out-of-range bins and classes; and one table too large for a block's
    shared memory, which takes the kernel's global-memory path."""
    xs, ys, C, B = chunk
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
    churn_w = (1, 8, 8, 2, 4, 1, 1, 1)[:F]
    wide_w = tuple(1 + (7 * f) % 40 for f in range(32))
    return [
        ("K1", "main-path chunk 0", C, B, None, real),
        ("K1", "churn", C, B, None, synth(TRAIN_ROWS, F, C, i8, -1, B + 2, 1)),
        ("K1", "wide", 8, 32, None, synth(TOTAL_ROWS, 32, 8, i32, -1, 34, 2)),
        ("K1", "global-memory table", 8, 128, None,
         synth(1 << 18, 64, 8, i32, -1, 130, 3)),
        ("K2", "churn", C, B, churn_w,
         synth(TRAIN_ROWS, F, C, i8, -40, 127, 4)),
        ("K2", "wide", 8, 32, wide_w,
         synth(TOTAL_ROWS, 32, 8, i32, -400, 1300, 5)),
    ]


def run_kernel_case(torch, histogram, kid, tag, C, B, widths, make_inputs
                    ) -> dict:
    """Hold one kernel against its plain version on the same inputs
    (exact equality: the counts are integers); time the kernel, the plain
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
    ops = n * F * (4 if widths else 3)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    dtype = str(x.dtype).replace("torch.", "")
    masked = ", mask" if mask is not None else ""
    del x, y, mask, got, want, binned, key, valid, acc
    torch.cuda.empty_cache()
    return {"name": f"{kid} {name} [{tag}: n={n} F={F} C={C} B={B} "
                    f"{dtype}{masked}]",
            "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": PALLAS_KERNEL, "kid": kid,
            "launches": 0, "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def write_churn_data(gen_telecom_churn) -> tuple:
    """The benchmark's input: 50,000 seeded base rows repeated to 2M; the
    first 1.6M train, the last 400k are scored."""
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
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


def breakdown(torch, train_dir: str, base_cfg: dict, card: str) -> None:
    """Where the training time goes: the host encode alone (host clock),
    then one more training run on the card under ``torch.profiler``, whose
    device time by kernel gives the device's busy and idle share."""
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        BayesianDistribution(JobConfig(dict(base_cfg)), device="cuda").run(
            train_dir, os.path.join(WORK, "model_profiled"))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    by_kind = {"histogram kernel": 0.0, "host-to-device copy": 0.0,
               "other device work": 0.0}
    launches = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if not us:
            continue
        if "histogram_kernel" in e.key:
            by_kind["histogram kernel"] += us
            launches += e.count
        elif "HtoD" in e.key:
            by_kind["host-to-device copy"] += us
        else:
            by_kind["other device work"] += us
    busy_ms = sum(by_kind.values()) / 1e3
    log(f"train breakdown: host encode alone {encode_s:.3f} s of a "
        f"{wall_s:.3f} s profiled train run [{card}]")
    if busy_ms == 0:
        log("device time: not measured (the profiler saw no device activity)")
        return
    parts = ", ".join(f"{k} {v / 1e3:.4f} ms" for k, v in by_kind.items())
    log(f"device busy {busy_ms:.4f} ms ({parts}; {launches} kernel launches, "
        f"{by_kind['histogram kernel'] / max(launches, 1):.2f} us each); "
        f"device idle share {1 - busy_ms / 1e3 / wall_s:.6f} [{card}]")


def read_bytes(path: str) -> bytes:
    with open(os.path.join(path, "part-r-00000"), "rb") as fh:
        return fh.read()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2

    from avenir_tpu_torch.core.config import JobConfig
    from avenir_tpu_torch.core.io import read_lines, split_line
    from avenir_tpu_torch.datagen import gen_telecom_churn
    from avenir_tpu_torch.models.bayesian import (BayesianDistribution,
                                                  BayesianPredictor)
    from avenir_tpu_torch.ops import _build, histogram

    try:
        import triton
        triton_info = f"triton {triton.__version__}"
    except ImportError as e:
        triton_info = f"triton not importable ({e})"
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {triton_info}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    _build.build()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s ({_build.sources()})")

    train_dir, test_dir = write_churn_data(gen_telecom_churn)

    # -- kernels against their plain versions -------------------------------
    entries = []
    for case in kernel_cases(torch, main_path_chunk(train_dir)):
        e = run_kernel_case(torch, histogram, *case)
        entries.append(e)
        log(f"{e['name']}: exact; kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, bincount {e['library_ms']:.4f} ms, "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}) [{card}]")

    # -- the main path: train on the card, score on the card ----------------
    n_test = TOTAL_ROWS - TRAIN_ROWS
    n_chunks = math.ceil(TRAIN_ROWS / CHUNK_ROWS)
    base_cfg = {"feature.schema.file.path": SCHEMA,
                "pipeline.chunk.rows": str(CHUNK_ROWS)}

    def train(device, out):
        t = time.perf_counter()
        counters = BayesianDistribution(JobConfig(dict(base_cfg)),
                                        device=device).run(train_dir, out)
        return counters, time.perf_counter() - t

    def predictor(model, precision, device):
        cfg = dict(base_cfg, **{"bayesian.model.file.path": model,
                                "bp.score.precision": precision})
        return BayesianPredictor(JobConfig(cfg, "bp"), device=device)

    def score(model, precision, device, out):
        job = predictor(model, precision, device)
        t = time.perf_counter()
        counters = job.run(test_dir, out)
        return counters, time.perf_counter() - t

    model_gpu = os.path.join(WORK, "model_cuda")
    histogram.reset_launch_counts()
    counters, train_s = train("cuda", model_gpu)
    _, score64_s = score(model_gpu, "float64", "cuda",
                         os.path.join(WORK, "pred64_cuda"))
    _, score32_s = score(model_gpu, "float32", "cuda",
                         os.path.join(WORK, "pred32_cuda"))
    launches = {"K1": histogram.K1_LAUNCHES, "K2": histogram.K2_LAUNCHES}
    log(f"main path launches: {launches}; chunks {counters.get('Ingest', 'Chunks')}")
    if launches["K1"] != n_chunks or counters.get("Ingest", "Chunks") != n_chunks:
        raise AssertionError(f"K1 launched {launches['K1']} times on the main "
                             f"path; expected one per chunk ({n_chunks})")
    for e in entries:
        e["launches"] = launches[e.pop("kid")]

    # -- the same jobs on the CPU; outputs must agree ------------------------
    model_cpu = os.path.join(WORK, "model_cpu")
    _, train_cpu_s = train("cpu", model_cpu)
    _, score64_cpu_s = score(model_cpu, "float64", "cpu",
                             os.path.join(WORK, "pred64_cpu"))
    if read_bytes(model_gpu) != read_bytes(model_cpu):
        raise AssertionError("model file differs between cuda and cpu")
    if not read_bytes(model_gpu):
        raise AssertionError("empty model file")
    p64 = read_bytes(os.path.join(WORK, "pred64_cuda"))
    if p64 != read_bytes(os.path.join(WORK, "pred64_cpu")):
        raise AssertionError("float64 predictions differ between cuda and cpu")
    if p64.count(b"\n") != n_test:
        raise AssertionError("prediction count is not the scored row count")

    records = [split_line(l) for l in read_lines(test_dir)]
    _, tables, probs64, _, _ = predictor(model_cpu, "float64", "cpu").score(records)
    ds, _, probs32, _, _ = predictor(model_gpu, "float32", "cuda").score(records)
    post, prior, gauss_post, gauss_prior, class_prior, is_cont = tables
    lfp, lfpo = BayesianPredictor.log_oracle(ds.x, ds.values, post, prior,
                                             gauss_post, gauss_prior, is_cont)
    viol = BayesianPredictor.f32_score_parity_violations(
        probs64, probs32, lfp, lfpo, class_prior, ln_healthy=math.log(1e-250))
    log(f"float32 (cuda) vs float64 (cpu) parity: {viol}")
    if viol["healthy"] or viol["tail"] or not viol["n_healthy"]:
        raise AssertionError(f"float32 scoring parity contract broken: {viol}")

    log(f"train (cuda): {TRAIN_ROWS / train_s:.0f} rows/s ({train_s:.3f} s, "
        f"{n_chunks} chunks of {CHUNK_ROWS}) [{card}]")
    log(f"score float64 (cuda): {n_test / score64_s:.0f} rows/s "
        f"({score64_s:.3f} s) [{card}]")
    log(f"score float32 (cuda): {n_test / score32_s:.0f} rows/s "
        f"({score32_s:.3f} s) [{card}]")
    log(f"train (cpu): {TRAIN_ROWS / train_cpu_s:.0f} rows/s; score float64 "
        f"(cpu): {n_test / score64_cpu_s:.0f} rows/s")
    log("model file and float64 predictions: byte-identical cuda vs cpu")
    breakdown(torch, train_dir, base_cfg, card)

    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
