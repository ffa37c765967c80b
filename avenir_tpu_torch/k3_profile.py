"""Where kernel K3's time goes, on a CUDA card::

    python -m avenir_tpu_torch.k3_profile

Builds three variants of ``csrc/topk.cu`` side by side (one ``nvcc`` each,
all at once, into ``build/k3_profile/``): the shipped kernel; the same
kernel with the per-tile selection skipped, so only the layout prologue
and the FMA loop run (its results are meaningless; it is timed only); and
the shipped kernel with ``clock64`` counters that split each block's time
into the FMA loop, the guard's pass and the merges.  For each shape it
prints the shipped and loop-only times (CUDA events, mean of 5 after a
warm-up) and, per block and candidate tile, the cycles of each phase as
thread 0 of the block sees them (the pass includes the wait for the
block's slowest warp).  The selection's cost is the difference between
the two times.  Needs the CUDA toolkit's ``nvcc``, like the kernels.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import torch

from .ops import _build, topk

OUT = _build.BUILD_DIR / "k3_profile"
SEL = "        // ---- selection for this tile"

# (label, nq, nt, F, C, k, algorithm, forced segments)
SHAPES = [
    ("kNN job (bench.py:1119)", 16384, 16384, 256, 0, 16, "euclidean", None),
    ("kNN job, 1 segment", 16384, 16384, 256, 0, 16, "euclidean", 1),
    ("64 queries", 64, 65536, 256, 0, 16, "euclidean", None),
    ("k=64", 2048, 16384, 256, 0, 64, "euclidean", None),
    ("1,050,000 candidates", 2048, 1_050_000, 64, 0, 16, "euclidean", None),
    ("manhattan", 4096, 16384, 64, 0, 16, "manhattan", None),
    ("4 categorical", 4096, 65536, 32, 4, 9, "euclidean", None),
]


def _patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"csrc/topk.cu no longer has {old.strip()!r}")
    return src.replace(old, new)


def variants(src: str) -> dict:
    """The three sources: shipped, loop-only and with phase counters."""
    loop_only = _patch(src, SEL, """        {   // keep the FMA loop alive
            float z = 0.f;
            for (int i = 0; i < 8; ++i)
                for (int j = 0; j < 8; ++j) z += acc[i][j];
            if (z == 1234.5f) lists[0] = 0;
        }
        continue;
""" + SEL)
    c = src
    for old, new in [
            ("namespace {\n",
             "__device__ unsigned long long k3_phase[6];\nnamespace {\n"),
            ("    int step = 0;\n",
             "    long long ph[4] = {0, 0, 0, 0};\n    int step = 0;\n"),
            ("        float acc[8][8];",
             "        const long long c0 = clock64();\n        float acc[8][8];"),
            (SEL, "        const long long c1 = clock64();\n" + SEL),
            ("        for (;;) {\n",
             "        for (;;) {\n            long long ca = clock64();\n"),
            ("            if (!__syncthreads_or(due_seen)) break;\n",
             "            if (!__syncthreads_or(due_seen)) {\n"
             "                ph[2] += clock64() - ca;\n                break;\n"
             "            }\n            ph[2] += clock64() - ca;\n"
             "            ca = clock64();\n"),
            ("            if (!*more) break;\n",
             "            ph[3] += clock64() - ca;\n            if (!*more) break;\n"),
            ("    }\n    cp_async_wait<0>();\n",
             "        ph[0] += c1 - c0;\n        ph[1] += clock64() - c1;\n"
             "    }\n    cp_async_wait<0>();\n    if (tid == 0) {\n"
             "        for (int q = 0; q < 4; ++q)\n"
             "            atomicAdd(&k3_phase[q], (unsigned long long)ph[q]);\n"
             "        atomicAdd(&k3_phase[4], 1ull);\n"
             "        atomicAdd(&k3_phase[5], (unsigned long long)(tile1 - tile0));\n"
             "    }\n")]:
        c = _patch(c, old, new)
    c += """
extern "C" int k3_phase_read(unsigned long long* out) {
    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    cudaError_t err = cudaMemcpyFromSymbol(out, k3_phase, sizeof(zero));
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbol(k3_phase, zero, sizeof(zero));
    return (int)err;
}
"""
    return {"shipped": src, "loop only": loop_only, "counters": c}


def build(sources: dict) -> dict:
    """One ``nvcc`` per variant, all started together; the loaded
    libraries."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = OUT / f"topk_{i}.cu", OUT / f"libtopk_{i}.so"
        cu.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def use(lib) -> None:
    """Route ``ops.topk``'s wrapper to ``lib``."""
    _build._libs["topk"] = lib
    topk._lib_topk = None


def operands(nq, nt, F, C, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qn = torch.rand((nq, F), generator=g, device="cuda")
    tn = torch.rand((nt, F), generator=g, device="cuda")
    qc = torch.randint(0, 4, (nq, C), generator=g, device="cuda",
                       dtype=torch.int32)
    tc = torch.randint(0, 4, (nt, C), generator=g, device="cuda",
                       dtype=torch.int32)
    cw = torch.ones(C, device="cuda")
    return qn, qc, tn, tc, cw, float(F + C)


def time_ms(fn, reps: int = 5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_profile needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    t = time.perf_counter()
    libs = build(variants((_build.CSRC_DIR / "topk.cu").read_text()))
    print(f"card: {card}; three variants built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counts = (ctypes.c_ulonglong * 6)()
    for label, nq, nt, F, C, k, alg, split in SHAPES:
        ops = operands(nq, nt, F, C)

        def run():
            return topk.fused_pairwise_topk(*ops, 1000, k, alg, split=split)

        ms = {}
        for name in ("shipped", "loop only"):
            use(libs[name])
            ms[name] = time_ms(run)
        use(libs["counters"])
        libs["counters"].k3_phase_read(counts)
        run()
        torch.cuda.synchronize()
        libs["counters"].k3_phase_read(counts)
        tiles = max(counts[5], 1)
        loop, sel, pas, merge = (counts[q] / tiles for q in range(4))
        bm, splits, _ = topk.k3_plan(nq, nt, sms, split)
        print(f"K3 [{label}: nq={nq} nt={nt} F={F} C={C} k={k} {alg}, "
              f"{bm}-row tiles x {splits} segments]: shipped "
              f"{ms['shipped']:.4f} ms, FMA loop only "
              f"{ms['loop only']:.4f} ms; cycles per block and tile: loop "
              f"{loop:.0f}, selection {sel:.0f} (guard pass {pas:.0f}, "
              f"merges {merge:.0f}) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
