// K3: fused weighted distance + exact k-smallest selection for kNN.
//
// Replaces the Pallas kernel avenir_tpu/ops/pallas_topk.py:226
// (_make_kernel, launched by _bins_pallas_call :336 at pallas_call :358,
// entered through fused_pairwise_topk :489).  Per (query, candidate) pair
// it computes, in the reference's order (pallas_topk.py:262-292, which
// mirrors ops/distance.py::_block_dist):
//
//   1. euclidean: max(q2 + t2 - 2 q.t, 0); manhattan: sum |q - t|
//      (left to right over the columns);
//   2. + sum_c w_c [qc != tc] (left to right over the categorical columns);
//   3. / wsum;  4. sqrt (euclidean only);
//   5. min(d * scale, 2147483392.0) truncated to int32;
//
// and keeps, per query row, the k smallest (value, index) pairs in
// ascending lexicographic order, lowest candidate index first on ties, as
// unique int64 keys (value << 32) | index.  Empty slots hold INT32_MAX and
// -1.  The list is exact, so no row is ever flagged as suspect.
//
// What bounds it on the H100 (SXM, 700 W): the cross term, 2 nq nt F
// FLOPs (manhattan: an FADD for the difference and an FADD with |.| per
// pair and column, 4 "ops" at the 67 TFLOP/s float32 rate), on the CUDA
// cores: TF32 is barred (pallas_topk.py:267-269) and wgmma has no float32
// path, so the tensor cores stay out.  The bytes (each input read once, k
// keys written per row) are far smaller: the kernel is bound by
// operations.
//
// The design of PR 2 (32 query rows x 128 candidates per block, a 4x4
// micro-tile fed by 8 scalar shared-memory loads per 16 FMAs, synchronous
// 4-byte staging with an index division per element, a grid over query
// rows only, the full int chain and a warp-wide insertion per surviving
// pair) took 9.70 ms at nq = nt = 16,384, F = 256, k = 16 against a
// 2.05 ms bound, and 93.2 ms on a 1,050,000-row candidate axis with 2,048
// queries.  This design answers each of those limits:
//
//   - layout_kernel, once per operand and call: the numeric columns
//     F-major ([F, n] padded with zeros to whole tiles and to a multiple
//     of FK columns) and each row's squared norm, summed left to right
//     with FMAs.  The main kernel then loads 16-byte chunks with no
//     bounds checks and never recomputes a norm;
//   - topk_kernel: a block owns BM = 128 query rows (64 for small query
//     counts) and walks the 128-candidate tiles of one segment of the
//     candidate axis.  Each thread holds an 8x8 register micro-tile, read
//     per column with four 128-bit shared-memory loads for 64 FMAs, so
//     the FMA pipe and not shared memory is the limit;
//   - staging: a ring of STAGES = 3 FK = 16-column stages filled with
//     16-byte cp.async.cg and cp.async.wait_group; the ring runs across
//     tile boundaries, so the next tile's loads overlap this tile's
//     selection;
//   - a split candidate axis: the grid is query tiles x S segments, with
//     S chosen by the caller so that the grid fills the card; with S > 1
//     each block writes the sorted k keys of its segment to a scratch
//     [S, nq, k], and merge_kernel merges the S lists of each row (the
//     keys are unique, so the merge is exact).  The blocks of one query
//     tile share each row's k-th value through a global atomicMin, which
//     tightens every segment's guard (see gkth in topk_kernel).  The
//     feature axis is never split: each pair's FMA chain (euclidean) or
//     sum (manhattan) runs over the columns in order, as in the plain
//     version;
//   - a guard before the exact chain (see parts_at_least): a pair is
//     rejected on its `parts` and index alone, a row of 8 pairs at a time
//     in 5 instructions a pair, so division, square root and the key run
//     only for the pairs that may enter.  The first tile of a segment
//     takes a bound from the tile itself, so it does not admit all 128
//     candidates of every row;
//   - batched selection: pairs that pass go to a per-row buffer of CAP
//     (parts, index) entries in shared memory (one shared atomic each).
//     A row is merged once it holds MERGE_AT entries, overflows, or its
//     segment ends: one warp computes the entries' exact keys, merges them
//     into the row's sorted list by rank and derives the row's new bounds
//     (16 candidates per bound, one per lane).  A full buffer keeps the
//     overflowing pairs pending in the thread that holds them; they retry
//     against the new k-th key after the merge.
//
// What still bounds it (H100 80GB HBM3, 700 W, `python -m
// avenir_tpu_torch.k3_profile`, PERF.md): the FMA loop runs at about 61%
// of the float32 rate, near cuBLAS's float32 product (68%); the selection
// adds about a quarter of the loop's time at the main shape,
// latency-bound with 8 warps per SM.
//
// The multi-device engines (ops/distance.py::pairwise_topk_ring, the
// model axis of ops/topk.py::fused_pairwise_topk) run this kernel on one
// tile of the candidate axis at a time: with an index base its keys carry
// the tile's global rows, in its keys-out form it leaves each segment's
// list as keys, and merge_kernel's keys-out form folds those lists into a
// running list (a ring hop's carry) and the carry's k-th values, which
// seed the next tile's gkth.  The reference's TPU ring carried 128 bins of
// 4 packed registers per row and re-resolved the rows whose bins
// overflowed (ops/distance.py:301-440); exact lists need none of that.
//
// C entry points (plain C interface, loaded with ctypes):
//   avenir_topk(...)             prologue + main kernel on the given
//                                stream; cudaGetLastError() after them;
//   avenir_topk_merge(...)       merge_kernel (K3m) on a MergePlan,
//                                likewise;
//   avenir_topk_device(...)      the SM count and opt-in shared memory;
//   avenir_topk_merge_prepare(b) merge_kernel allowed b shared bytes;
//   avenir_topk_error_string(e)  the CUDA error string.

#include <cuda_runtime.h>
#include <stdint.h>

// K3m's launch plan, computed on the host (ops/topk.py::merge_plan, read
// through ops/topk.py::_MergePlan in this order): the shape, then a
// block's `rows` consecutive rows of `warps` warps each; `slots` lists a
// row in shared memory ([slots][rows][k] keys, `smem` bytes); `rounds`
// staging rounds (the first fills every slot, each later one slots 1..);
// `grid` blocks.
struct MergePlan {
  int32_t S, nq, k, warps, rows, slots, rounds, smem, grid;
};

namespace {

constexpr int BN = 128;         // candidate rows per tile
constexpr int FK = 16;          // feature columns per stage
constexpr int STAGES = 3;       // stages in the cp.async ring
constexpr int CAP = 32;         // buffered pairs per row
constexpr int MERGE_AT = 16;    // buffered pairs that make a row due
constexpr int MAX_K = 64;
constexpr int MAX_CAT = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SENT = 0x7fffffffffffffffLL;
constexpr float VMAX = 2147483392.0f;

template <bool B>
struct Flag { static constexpr bool value = B; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// prologue: F-major operand and squared norms
// ---------------------------------------------------------------------------

// src [n, F] row-major -> dst [Fpad, ld] (zeros past n and past F) and
// norms[ld] (each row's sum of squares, left to right over the columns).
// A block of 32 x 8 threads transposes 32 rows, 32 columns at a time.
__global__ void __launch_bounds__(256)
layout_kernel(const float* __restrict__ src, int n, int F, int Fpad, int ld,
              float* __restrict__ dst, float* __restrict__ norms) {
    __shared__ float tile[32][33];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const long long r0 = (long long)blockIdx.x * 32;
    float s = 0.f;
    for (int f0 = 0; f0 < Fpad; f0 += 32) {
        for (int rr = ty; rr < 32; rr += 8) {
            const long long r = r0 + rr;
            const int f = f0 + tx;
            tile[rr][tx] = (r < n && f < F) ? src[r * F + f] : 0.f;
        }
        __syncthreads();
        for (int ff = ty; ff < 32; ff += 8)
            if (f0 + ff < Fpad)
                dst[(size_t)(f0 + ff) * ld + r0 + tx] = tile[tx][ff];
        if (ty == 0)
            for (int ff = 0; ff < 32; ++ff)
                s = fmaf(tile[tx][ff], tile[tx][ff], s);
        __syncthreads();
    }
    if (ty == 0) norms[r0 + tx] = s;
}

// ---------------------------------------------------------------------------
// the exact int chain and the guard
// ---------------------------------------------------------------------------

template <bool EUCLID>
__device__ __forceinline__ int int_value(float parts, float wsum,
                                         float scale) {
    float d = __fdiv_rn(parts, wsum);
    if (EUCLID) d = __fsqrt_rn(d);
    return (int)fminf(__fmul_rn(d, scale), VMAX);
}

// The guard.  Every step from `parts` to the int value (division by
// wsum > 0, sqrt, multiplication by scale > 0, min with the cap,
// truncation of a non-negative float) is monotone non-decreasing, so
// int_value is, for parts >= 0.  parts_at_least(v) returns a P >= 0 with
// int_value(P) >= v: the chain's inverse in float, checked with the exact
// chain itself and stepped up an ulp at a time until it passes, or
// +infinity where it finds none.  With the row's k-th key (vk << 32) | ik,
// a block keeps hi = parts_at_least(vk + 1) and eq = parts_at_least(vk)
// and rejects a pair (parts, col) when
//
//   parts >= hi:              int_value(parts) > vk, so its key exceeds
//                             the k-th key whatever its index;
//   parts >= eq and col > ik: int_value(parts) >= vk and a larger index,
//                             so again its key exceeds the k-th key.
//
// Either way the full chain would reject it too: the guard never rejects
// a pair the full chain accepts.  A loose bound (a few ulps high) only
// lets more pairs through to the exact chain.  An empty slot (no k-th
// key), a k-th value at the cap, or a non-positive wsum or scale give
// +infinity: nothing is rejected.  NaN parts pass (both tests are false),
// as the exact chain maps them to the cap.
template <bool EUCLID>
__device__ float parts_at_least(long long v, float wsum, float scale) {
    const float inf = __int_as_float(0x7f800000);
    if (v > (long long)VMAX || !(wsum > 0.f) || !(scale > 0.f)) return inf;
    if (v <= 0) return 0.f;
    const float d = __fdiv_rn((float)v, scale);
    const float p0 = EUCLID ? d * d * wsum : d * wsum;
    if (!(p0 < inf)) return inf;
    // two ulps up from the inverse: most often the first candidate passes
    float P = __int_as_float(__float_as_int(p0) + 2);
    for (int it = 0; it < 64; ++it) {
        if (int_value<EUCLID>(P, wsum, scale) >= v) return P;
        P = nextafterf(P, inf);
    }
    return inf;
}

// hi and eq of a row whose k-th value is vk, for the whole warp: lanes
// 0-15 look for hi (v = vk + 1), lanes 16-31 for eq (v = vk), each at one
// of 16 floats from 2 ulps below to 13 ulps above the chain's inverse;
// the lowest lane whose candidate passes the exact chain wins, and where
// none passes the bound is +infinity (as parts_at_least).
template <bool EUCLID>
__device__ __forceinline__ float2 row_bounds(long long vk, float wsum,
                                             float scale, int lane) {
    const float inf = __int_as_float(0x7f800000);
    const long long v = lane < 16 ? vk + 1 : vk;
    float P = inf;
    bool ok = false;
    if (v <= (long long)VMAX && wsum > 0.f && scale > 0.f) {
        P = 0.f;
        if (v > 0) {
            const float d = __fdiv_rn((float)v, scale);
            const float p0 = EUCLID ? d * d * wsum : d * wsum;
            P = p0 < inf ? __int_as_float(max(
                               __float_as_int(p0) + (lane & 15) - 2, 0))
                         : inf;
        }
        ok = P < inf && int_value<EUCLID>(P, wsum, scale) >= v;
    }
    const unsigned m = __ballot_sync(FULL, ok);
    const float h = __shfl_sync(FULL, P, (__ffs(m & 0xffffu) - 1) & 31);
    const float e = __shfl_sync(FULL, P, (__ffs(m >> 16) + 15) & 31);
    return make_float2(m & 0xffffu ? h : inf, m >> 16 ? e : inf);
}

// `parts` plus the categorical mismatch sum of one pair, left to right
// over the columns (just the sum where there are no numeric columns).
// Out of line: the micro-tile's 64 pairs share one copy.
__device__ __noinline__ float add_categorical(float parts, bool numeric,
                                              const int* qrow,
                                              const int* trow,
                                              const float* cat_w, int Cc) {
    float ca = 0.f;
    for (int c = 0; c < Cc; ++c) {
        const float term = qrow[c] != trow[c] ? cat_w[c] : 0.f;
        ca = c ? __fadd_rn(ca, term) : term;
    }
    return numeric ? __fadd_rn(parts, ca) : ca;
}

// ---------------------------------------------------------------------------
// the main kernel
// ---------------------------------------------------------------------------

__host__ __device__ constexpr size_t stage_floats(int bm) {
    return (size_t)STAGES * FK * (bm + BN);
}

__host__ __device__ constexpr size_t smem_bytes(int bm, int k, int cc) {
    return sizeof(float) * stage_floats(bm)           // cp.async ring
           + sizeof(long long) * bm * (k + CAP + 1)   // lists, buffers, k-th
           + sizeof(float) * (4 * bm + BN)            // bounds, norms
           + sizeof(int) * (2 * bm + 4)               // counts, flag
           + sizeof(int) * (bm * cc + BN * (cc + 1)); // categorical codes
}

// One block: query rows [q0, q0 + BM) against candidate tiles
// [tile0, tile1).  Thread (tx, ty) = (tid % 16, tid / 16) owns rows
// ty*4 + {0..3} and BM/2 + ty*4 + {0..3} (micro-tile rows i = 0..7), and
// columns tx*4 + {0..3} and 64 + tx*4 + {0..3} of each tile (j = 0..7).
// A pair that passes the guard enters its row's buffer as (parts, col);
// the merge turns it into its exact key.
template <bool EUCLID, int BM>
__global__ void __launch_bounds__(2 * BM, 128 / BM)
topk_kernel(const float* __restrict__ qT, const float* __restrict__ tT,
            const float* __restrict__ q2, const float* __restrict__ t2,
            int F, int Fpad, int ldq, int ldt,
            const int* __restrict__ qc, const int* __restrict__ tc,
            const float* __restrict__ cat_w, int Cc, int nq, int nt,
            float wsum, float scale, int k, int tiles_per_seg,
            long long* __restrict__ seg_out, int* gkth,
            int* __restrict__ out_v, int* __restrict__ out_i, int idx_base) {
    constexpr int THREADS = 2 * BM;
    constexpr int HALF = BM / 2;
    extern __shared__ __align__(16) unsigned char smem[];
    float* ring = reinterpret_cast<float*>(smem);
    long long* lists = reinterpret_cast<long long*>(ring + stage_floats(BM));
    unsigned long long* buf =                        // [BM][CAP]
        reinterpret_cast<unsigned long long*>(lists + BM * k);
    long long* kth = reinterpret_cast<long long*>(buf + BM * CAP);
    float* hi = reinterpret_cast<float*>(kth + BM);  // [BM] parts >= hi: out
    float* eq = hi + BM;                             // [BM] see parts_at_least
    float* q2s = eq + BM;                            // [BM] query norms
    float* t2s = q2s + BM;                           // [BN] the tile's norms
    float* gb = t2s + BN;                            // [BM] see gkth below
    int* cnt = reinterpret_cast<int*>(gb + BM);      // [BM]
    int* gseen = cnt + BM;                           // [BM]
    int* more = gseen + BM;
    int* qcs = more + 4;                             // [BM][Cc]
    int* tcs = qcs + BM * Cc;                        // [BN][Cc + 1]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * BM;
    const int ntiles = (nt + BN - 1) / BN;
    const int tile0 = blockIdx.y * tiles_per_seg;
    const int tile1 = min(tile0 + tiles_per_seg, ntiles);
    const int nk = Fpad / FK;
    const float inf = __int_as_float(0x7f800000);

    for (int i = tid; i < BM * k; i += THREADS) lists[i] = SENT;
    for (int r = tid; r < BM; r += THREADS) {
        kth[r] = SENT;
        gb[r] = inf;
        gseen[r] = 0x7fffffff;
        hi[r] = eq[r] = inf;
        q2s[r] = EUCLID && F ? q2[q0 + r] : 0.f;
        cnt[r] = 0;
    }
    if (tid == 0) *more = 0;
    for (int i = tid; i < BM * Cc; i += THREADS) {
        const int r = i / Cc;
        qcs[i] = q0 + r < nq ? qc[(long long)q0 * Cc + i] : 0;
    }

    // the cp.async ring walks the steps (tile, kt) of the whole segment
    const int steps = (tile1 - tile0) * nk;
    int ld_tile = tile0, ld_kt = 0, ld_step = 0;
    auto load_step = [&](int slot) {
        if (ld_step < steps) {
            float* As = ring + (size_t)slot * FK * (BM + BN);
            float* Bs = As + FK * BM;
            const size_t f0 = (size_t)ld_kt * FK;
#pragma unroll
            for (int c = tid; c < FK * BM / 4; c += THREADS) {
                const int f = c / (BM / 4), x4 = c % (BM / 4);
                cp_async16(As + f * BM + x4 * 4,
                           qT + (f0 + f) * ldq + q0 + x4 * 4);
            }
#pragma unroll
            for (int c = tid; c < FK * BN / 4; c += THREADS) {
                const int f = c / (BN / 4), x4 = c % (BN / 4);
                cp_async16(Bs + f * BN + x4 * 4,
                           tT + (f0 + f) * ldt + (size_t)ld_tile * BN
                               + x4 * 4);
            }
            if (++ld_kt == nk) { ld_kt = 0; ++ld_tile; }
        }
        ++ld_step;
        cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) load_step(s);

    int step = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

        for (int kt = 0; kt < nk; ++kt, ++step) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();
            load_step((step + STAGES - 1) % STAGES);
            const float* As = ring + (size_t)(step % STAGES) * FK * (BM + BN);
            const float* Bs = As + FK * BM;
#pragma unroll
            for (int f = 0; f < FK; ++f) {
                const float4 a0 = *reinterpret_cast<const float4*>(
                    As + f * BM + ty * 4);
                const float4 a1 = *reinterpret_cast<const float4*>(
                    As + f * BM + HALF + ty * 4);
                const float4 b0 = *reinterpret_cast<const float4*>(
                    Bs + f * BN + tx * 4);
                const float4 b1 = *reinterpret_cast<const float4*>(
                    Bs + f * BN + 64 + tx * 4);
                const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                    a1.x, a1.y, a1.z, a1.w};
                const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        if (EUCLID)
                            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
                        else
                            acc[i][j] = __fadd_rn(
                                acc[i][j], fabsf(__fsub_rn(a[i], b[j])));
                    }
            }
        }

        // ---- selection for this tile ------------------------------------
        const int t0 = tile * BN;
        if (Cc) {
            for (int i = tid; i < BN * Cc; i += THREADS) {
                const int r = i / Cc, c = i - r * Cc;
                tcs[r * (Cc + 1) + c] =
                    t0 + r < nt ? tc[(long long)t0 * Cc + i] : 0;
            }
        }
        if (EUCLID && F)
            for (int c = tid; c < BN; c += THREADS) t2s[c] = t2[t0 + c];
        // With a split axis the blocks of one query tile share their rows'
        // k-th values through gkth (an atomicMin after each merge).  Every
        // segment's k-th value is at least the final k-th value of the
        // whole row, so a pair whose value exceeds any of them cannot be
        // in the answer: gb = parts_at_least(g + 1) rejects only such
        // pairs.  A segment's list may then lose pairs of its own k
        // smallest, but never one of the row's k smallest, so the merge of
        // the segments' lists stays exact.
        if (gkth)
            for (int r = tid; r < BM; r += THREADS) {
                if (q0 + r >= nq) continue;
                const int g = *(volatile const int*)(gkth + q0 + r);
                if (g < gseen[r]) {
                    gseen[r] = g;
                    gb[r] = parts_at_least<EUCLID>((long long)g + 1, wsum,
                                                   scale);
                    hi[r] = fminf(hi[r], gb[r]);
                }
            }
        __syncthreads();

        // Offer the micro-tile's pairs that the guard lets through to
        // their rows' buffers; merge a row once its buffer holds MERGE_AT
        // entries, overflows, or the segment ends.  A pair that finds its
        // row's buffer full stays pending and is offered again, against
        // the new k-th key, until no buffer overflows.
        const bool last_tile = tile + 1 == tile1;
        float t2v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            t2v[j] = t2s[(j < 4 ? 0 : 64) + tx * 4 + (j & 3)];
        // `parts` of pair (i, j); NUM and CAT say at compile time whether
        // there are numeric and categorical columns, so the guard's loop
        // over the micro-tile has no branch
        auto parts_of = [&](auto num, auto cat, int i, int j) {
            const int row = (i < 4 ? 0 : HALF) + ty * 4 + (i & 3);
            const int cl = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
            float parts = 0.f;
            if (decltype(num)::value)
                parts = EUCLID
                    ? fmaxf(__fsub_rn(__fadd_rn(q2s[row], t2v[j]),
                                      __fmul_rn(2.f, acc[i][j])),
                            0.f)
                    : acc[i][j];
            if (decltype(cat)::value)
                parts = add_categorical(parts, decltype(num)::value,
                                        qcs + row * Cc, tcs + cl * (Cc + 1),
                                        cat_w, Cc);
            return parts;
        };
        auto parts_any = [&](int i, int j) {
            return !Cc ? parts_of(Flag<true>(), Flag<false>(), i, j)
                 : F   ? parts_of(Flag<true>(), Flag<true>(), i, j)
                       : parts_of(Flag<false>(), Flag<true>(), i, j);
        };
        if (tile == tile0) {
            // The segment's first tile, with every list empty: a first
            // bound from the tile itself.  Per row, each of the 16 lanes
            // that hold it takes the m-th smallest of its 8 `parts`
            // (m = ceil(k / 16)); at least 16 m >= k pairs of the segment
            // then have parts in [0, U], U the largest of those, so the
            // segment's k-th value is at most int_value(U) and no pair
            // with parts >= parts_at_least(int_value(U) + 1) can enter.
            // Negative or NaN parts count as +infinity here.
            const int m = (k + 15) / 16;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int row = (i < 4 ? 0 : HALF) + ty * 4 + (i & 3);
                float p[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const unsigned col =
                        (unsigned)(t0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3));
                    const float v = parts_any(i, j);
                    p[j] = col < (unsigned)nt && v >= 0.f ? v : inf;
                }
                float u = inf;
                for (int s = 0; s < m; ++s) {       // the m-th smallest
                    u = p[0];
#pragma unroll
                    for (int j = 1; j < 8; ++j) u = fminf(u, p[j]);
                    bool taken = false;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const bool hit = !taken && p[j] == u;
                        taken |= hit;
                        p[j] = hit ? inf : p[j];
                    }
                }
#pragma unroll
                for (int off = 8; off; off >>= 1)
                    u = fmaxf(u, __shfl_xor_sync(FULL, u, off));
                if (tx == 0 && q0 + row < nq && u < inf)
                    hi[row] = fminf(hi[row], parts_at_least<EUCLID>(
                        (long long)int_value<EUCLID>(u, wsum, scale) + 1,
                        wsum, scale));
            }
            __syncthreads();
        }

        // The guard, row by row: a thread tests its 8 pairs of a row
        // against the row's hi bound only (5 instructions a pair), and
        // looks at the pairs one by one, with the index rule and the
        // offer, only where one of them may pass.  `pending` holds the
        // pairs still to offer: all of them on the first pass, the ones
        // that found a buffer full on a retry.
        unsigned long long pending = ~0ull;
        for (;;) {
            unsigned long long next = 0;
            bool due_seen = last_tile;
            auto offer_pass = [&](auto num, auto cat) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int row = (i < 4 ? 0 : HALF) + ty * 4 + (i & 3);
                    const float h = hi[row];
                    float p[8];
                    bool any = false;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        p[j] = parts_of(num, cat, i, j);
                        any |= !(p[j] >= h);
                    }
                    if (!any || q0 + row >= nq
                        || !(pending >> (i * 8) & 0xff))
                        continue;
                    const float e = fminf(eq[row], h);
                    const unsigned ik = (unsigned)kth[row];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const unsigned col = (unsigned)(
                            t0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3));
                        if (!(pending >> (i * 8 + j) & 1)
                            || col >= (unsigned)nt
                            || p[j] >= (col > ik ? e : h))
                            continue;
                        const int pos = atomicAdd(&cnt[row], 1);
                        due_seen |= pos + 1 >= MERGE_AT;
                        if (pos < CAP)
                            buf[row * CAP + pos] =
                                (unsigned long long)__float_as_uint(p[j])
                                    << 32 | col;
                        else
                            next |= 1ull << (i * 8 + j);
                    }
                }
            };
            if (!Cc) offer_pass(Flag<true>(), Flag<false>());
            else if (F) offer_pass(Flag<true>(), Flag<true>());
            else offer_pass(Flag<false>(), Flag<true>());
            pending = next;
            // a row is due with MERGE_AT entries, an overflow, or at the
            // segment's end; no row due in the block: nothing to merge
            if (!__syncthreads_or(due_seen)) break;
            // one warp per due row: the buffered pairs' exact keys, merged
            // into the sorted list by rank, then the row's new bounds
            for (int r = warp; r < BM; r += THREADS / 32) {
                const int n = cnt[r];
                if (n < MERGE_AT && !(n > 0 && last_tile)) continue;
                const int nb = min(n, CAP);
                long long* list = lists + r * k;
                long long bk = SENT;
                if (lane < nb) {
                    const unsigned long long ent = buf[r * CAP + lane];
                    bk = (long long)int_value<EUCLID>(
                             __uint_as_float((unsigned)(ent >> 32)), wsum,
                             scale) << 32
                         | (long long)(ent & 0xffffffffull);
                }
                const long long e0 = lane < k ? list[lane] : SENT;
                const long long e1 = lane + 32 < k ? list[lane + 32] : SENT;
                int r0 = lane, r1 = lane + 32, rb = 0;
                for (int t = 0; t < nb; ++t) {
                    const long long x = __shfl_sync(FULL, bk, t);
                    r0 += x < e0;
                    r1 += x < e1;
                    rb += x < bk;
                }
#pragma unroll 8
                for (int t = 0; t < k; ++t) rb += list[t] < bk;
                __syncwarp();
                if (lane < k && r0 < k) list[r0] = e0;
                if (lane + 32 < k && r1 < k) list[r1] = e1;
                if (lane < nb && rb < k) list[rb] = bk;
                __syncwarp();
                const long long last = list[k - 1];
                const float2 b = row_bounds<EUCLID>(last >> 32, wsum, scale,
                                                    lane);
                if (lane == 0) {
                    kth[r] = last;
                    hi[r] = fminf(b.x, gb[r]);
                    if (gkth && last != SENT)
                        atomicMin(gkth + q0 + r, (int)(last >> 32));
                    eq[r] = b.y;
                    cnt[r] = 0;
                    if (n > CAP) *more = 1;
                }
            }
            __syncthreads();
            if (!*more) break;
            __syncthreads();
            if (tid == 0) *more = 0;
        }
    }
    cp_async_wait<0>();

    for (int i = tid; i < BM * k; i += THREADS) {
        const int r = i / k, j = i - r * k;
        const long long gq = (long long)q0 + r;
        if (gq >= nq) continue;
        // the list holds indices within this call's candidates; the
        // index base shifts them to the caller's (a ring hop's, a model
        // shard's) global rows, under the same order
        const long long key = lists[i];
        if (seg_out) {
            seg_out[((long long)blockIdx.y * nq + gq) * k + j] =
                key == SENT ? SENT : key + idx_base;
        } else {
            out_v[gq * k + j] = key == SENT ? 0x7fffffff : (int)(key >> 32);
            out_i[gq * k + j] = key == SENT
                ? -1 : (int)(key & 0xffffffffLL) + idx_base;
        }
    }
}

// ---------------------------------------------------------------------------
// K3m: the merge of S sorted lists per row
// ---------------------------------------------------------------------------
//
// Replaces the merges the TPU ran outside Pallas: _lex_merge
// (avenir_tpu/ops/pallas_topk.py:402, a two-key jnp sort of the segments'
// and model shards' selections) and _merge_bins (avenir_tpu/ops/
// distance.py:130, a ring hop's Batcher merge).  Each row's S lists hold
// sorted unique int64 keys (value << 32) | index, INT64_MAX in empty
// slots; the row's answer is its k smallest keys.
//
// What bounds it on the H100: neither bytes nor operations.  A serving
// row is 16 KB (S = 128, k = 16), 5 ns at 3.35 TB/s; the time is the
// chain of dependent steps.  A warp per row folding the lists into a
// running list one after another (each step a global load, k rounds of
// two shuffles and a trip through shared memory) took (S - 1) steps of
// about 0.9 us, three times torch.topk at S = 128.  So:
//
//   - a row belongs to a group of `warps` warps (up to a whole block of
//     32 where rows are few), and a block to `rows` rows (up to 4 rows of
//     one warp each where they are many): the plan, ops/topk.py::
//     merge_plan, fills the card at every nq;
//   - all of a row's lists are staged in shared memory at once, in one
//     round of 16-byte cp.async copies, so a row pays one memory latency
//     and not one per list.  Where S lists do not fit a block (a caller's
//     gather; K3's plan gives at most 264 segments on this card) they are
//     staged in rounds, each later round behind the running list in slot
//     0;
//   - a tree of ceil(log2 n) levels of pairwise merges, each level's
//     pairs merged at once by the group's warps, in place: a pair is one
//     warp's, which reads both lists, __syncwarp, then writes list i's
//     slot.  Two lists' k smallest lie in the union of each one's k
//     smallest, so a pair keeps k;
//   - a key's place in the merged pair by a branch-free binary search in
//     the other list (count_upto: log2 k + 1 shared loads, the same code
//     for a lane of either list, so the warp does not split): a_j goes to
//     j + #(b < a_j), b_i to i + #(a <= b_i).  The ranks are distinct,
//     the empty slots' equal keys included, and every rank below k has
//     exactly one writer.
//
// A row is written only after all its lists were read (list 0 in the
// first round), and only by the block that owns it: the keys-out form may
// write into list 0 in place (a ring hop's carry).

constexpr int MERGE_TASKS = 2 * MAX_K / 32;   // a lane's keys of a pair

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

// #(list <= xl) over a sorted list of k keys (the caller's xl is x - 1
// for #(list < x), which wraps only at INT64_MIN, below every key of a
// value >= 0): a bit-lift binary search of log2(top) + 1 steps, top the
// highest power of two <= k (uniform in the block, so the unrolled steps
// it skips split no warp), each step one shared load and a select,
// without branches.  (Two such steps and then a count of the 16 keys
// left as independent loads measured slower on the H100 at every shape
// avenir_tpu_torch/merge_probe.py times.)
__device__ __forceinline__ int count_upto(const long long* list, int k,
                                          int top, long long xl) {
    int n = 0;
#pragma unroll
    for (int step = MAX_K; step; step >>= 1) {
        if (step > top) continue;
        const int m = n + step;
        n = m <= k && list[min(m, k) - 1] <= xl ? m : n;
    }
    return n;
}

__global__ void __launch_bounds__(1024)
merge_kernel(const long long* keys, const MergePlan p, int vec16,
             int* __restrict__ out_v, int* __restrict__ out_i,
             long long* keys_out, int* __restrict__ kth_out) {
    extern __shared__ __align__(16) long long slot[];  // [slots][rows][k]
    const int k = p.k, tid = threadIdx.x, lane = tid & 31;
    const int warp = tid >> 5, r = warp / p.warps, gw = warp - r * p.warps;
    const long long row0 = (long long)blockIdx.x * p.rows;
    const int nrows = (int)min((long long)p.rows, p.nq - row0);
    const int step = p.rows * k;                   // keys from slot to slot
    long long* mine = slot + r * k;                // this warp's row, slot 0
    // a warp step merges ppw pairs (2k keys each).  This lane's keys: key
    // e[j] of pair pj[j] of the step (-1 past the step), in the pair's
    // first list (in_b[j] false; ranked by #(b < key)) or its second
    // (ranked by #(a <= key))
    const int ppw = max(1, 32 / (2 * k)), top = 1 << (31 - __clz(k));
    const int tasks = (ppw * 2 * k + 31) / 32;     // this lane's keys a step
    int pj[MERGE_TASKS], e[MERGE_TASKS];
    bool in_b[MERGE_TASKS];
#pragma unroll
    for (int j = 0; j < MERGE_TASKS; ++j) {
        const int t = lane + 32 * j;
        pj[j] = t < ppw * 2 * k ? t / (2 * k) : -1;
        e[j] = t - max(pj[j], 0) * 2 * k;
        in_b[j] = e[j] >= k;
        e[j] -= in_b[j] ? k : 0;
    }
    int next = 0;                                  // the next list to stage
    for (int round = 0; round < p.rounds; ++round) {
        const int first = round ? 1 : 0;
        const int n_load = min(p.slots - first, p.S - next);
        const int per = nrows * k;                 // keys of one list
        const long long* src = keys + ((long long)next * p.nq + row0) * k;
        if (vec16) {
            const int vecs = per / 2;
            for (int i = tid; i < n_load * vecs; i += blockDim.x) {
                const int l = i / vecs, v = i - l * vecs;
                cp_async16(slot + (first + l) * step + 2 * v,
                           src + (long long)l * p.nq * k + 2 * v);
            }
        } else {
            for (int i = tid; i < n_load * per; i += blockDim.x) {
                const int l = i / per, v = i - l * per;
                cp_async8(slot + (first + l) * step + v,
                          src + (long long)l * p.nq * k + v);
            }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        next += n_load;
        const int n = first + n_load;
        for (int lg = 0; (1 << lg) < n; ++lg) {
            const int stride = 1 << lg;
            if (r < nrows) {
                const int pairs = ((n - 1 - stride) >> (lg + 1)) + 1;
                for (int c = gw * ppw; c < pairs; c += p.warps * ppw) {
                    long long x[MERGE_TASKS];
                    int at[MERGE_TASKS];
#pragma unroll
                    for (int j = 0; j < MERGE_TASKS; ++j) {
                        at[j] = k;                 // k: not written
                        const int q = c + pj[j];
                        if (j >= tasks || pj[j] < 0 || q >= pairs) continue;
                        const long long* a = mine + (2 * q << lg) * step;
                        const long long* b = a + stride * step;
                        x[j] = (in_b[j] ? b : a)[e[j]];
                        at[j] = e[j] + count_upto(in_b[j] ? a : b, k, top,
                                                  x[j] - !in_b[j]);
                    }
                    __syncwarp();
#pragma unroll
                    for (int j = 0; j < MERGE_TASKS; ++j)
                        if (j < tasks && at[j] < k)
                            mine[(2 * (c + pj[j]) << lg) * step + at[j]] =
                                x[j];
                }
            }
            if (p.warps == 1) __syncwarp(); else __syncthreads();
        }
        __syncthreads();        // the next round's copies or the output
    }
    // slot 0 is [rows][k]: the block's rows, contiguous as in the output
    for (int i = tid; i < nrows * k; i += blockDim.x) {
        const long long key = slot[i], g = row0 * k + i;
        if (keys_out) {
            keys_out[g] = key;
        } else {
            out_v[g] = key == SENT ? 0x7fffffff : (int)(key >> 32);
            out_i[g] = key == SENT ? -1 : (int)(key & 0xffffffffLL);
        }
    }
    // SENT >> 32 is INT32_MAX: an empty k-th slot bounds nothing
    if (keys_out && kth_out)
        for (int i = tid; i < nrows; i += blockDim.x)
            kth_out[row0 + i] = (int)(slot[i * k + k - 1] >> 32);
}

template <bool EUCLID, int BM>
cudaError_t launch_topk(const float* qT, const float* tT, const float* q2,
                        const float* t2, int F, int Fpad, int ldq, int ldt,
                        const int* qc, const int* tc, const float* cat_w,
                        int Cc, int nq, int nt, float wsum, float scale,
                        int k, int splits, int tiles_per_seg,
                        long long* seg_out, int* gkth, int* out_v,
                        int* out_i, int idx_base, cudaStream_t s) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        topk_kernel<EUCLID, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(BM, MAX_K, MAX_CAT));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((unsigned)((nq + BM - 1) / BM), (unsigned)splits);
    topk_kernel<EUCLID, BM><<<grid, 2 * BM, smem_bytes(BM, k, Cc), s>>>(
        qT, tT, q2, t2, F, Fpad, ldq, ldt, qc, tc, cat_w, Cc, nq, nt, wsum,
        scale, k, tiles_per_seg, seg_out, gkth, out_v, out_i, idx_base);
    return cudaGetLastError();
}

}  // namespace

// qn [nq, F], tn [nt, F] float32 row-major; qc [nq, Cc], tc [nt, Cc]
// int32; cat_w [Cc].  Scratch from the caller: qT [Fpad, ldq], tT [Fpad,
// ldt], q2 [ldq], t2 [ldt] (Fpad = F rounded up to 16, ldq = nq rounded
// up to bm, ldt = nt rounded up to 128; unused when F = 0).  bm is 64 or
// 128; the candidate tiles are cut into segments of tiles_per_seg.
// Candidate row c is reported as index idx_base + c.
//
// Output: with seg_out, the sorted k keys of each segment, seg_out
// [splits, nq, k] int64 (the keys-out form, at any splits); else, with
// splits = 1 only, out_v / out_i [nq, k] int32.  gkth [nq] int32 holds
// the rows' shared k-th values: required when splits > 1 (set to
// INT32_MAX, or to a k-th value already known for the row, such as a ring
// carry's: every entry must be at least the final k-th value of the row
// over all the lists that will be merged), optional otherwise.
extern "C" int avenir_topk(const float* qn, const float* tn, int F,
                           const int* qc, const int* tc, const float* cat_w,
                           int Cc, int nq, int nt, float wsum, float scale,
                           int k, int euclidean, int bm, int splits,
                           int tiles_per_seg, float* qT, float* tT,
                           float* q2, float* t2, long long* seg_out,
                           int* gkth, int* out_v, int* out_i, int idx_base,
                           void* stream) {
    if (k < 1 || k > MAX_K || Cc < 0 || Cc > MAX_CAT || F < 0 || nq < 0
        || nt < 0 || (bm != 64 && bm != 128) || splits < 1
        || tiles_per_seg < 0 || (splits > 1 && (!seg_out || !gkth))
        || (!seg_out && (!out_v || !out_i)) || idx_base < 0
        || (long long)idx_base + nt > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (nq == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int Fpad = (F + FK - 1) / FK * FK;
    const int ldq = (nq + bm - 1) / bm * bm;
    const int ldt = (nt + BN - 1) / BN * BN;
    if (F) {
        const dim3 block(32, 8);
        layout_kernel<<<ldq / 32, block, 0, s>>>(qn, nq, F, Fpad, ldq, qT,
                                                  q2);
        if (ldt)
            layout_kernel<<<ldt / 32, block, 0, s>>>(tn, nt, F, Fpad, ldt,
                                                      tT, t2);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    cudaError_t err;
    if (euclidean)
        err = bm == 128
            ? launch_topk<true, 128>(qT, tT, q2, t2, F, Fpad, ldq, ldt, qc,
                                     tc, cat_w, Cc, nq, nt, wsum, scale, k,
                                     splits, tiles_per_seg, seg_out, gkth,
                                     out_v, out_i, idx_base, s)
            : launch_topk<true, 64>(qT, tT, q2, t2, F, Fpad, ldq, ldt, qc,
                                    tc, cat_w, Cc, nq, nt, wsum, scale, k,
                                    splits, tiles_per_seg, seg_out, gkth,
                                    out_v, out_i, idx_base, s);
    else
        err = bm == 128
            ? launch_topk<false, 128>(qT, tT, q2, t2, F, Fpad, ldq, ldt, qc,
                                      tc, cat_w, Cc, nq, nt, wsum, scale, k,
                                      splits, tiles_per_seg, seg_out, gkth,
                                      out_v, out_i, idx_base, s)
            : launch_topk<false, 64>(qT, tT, q2, t2, F, Fpad, ldq, ldt, qc,
                                     tc, cat_w, Cc, nq, nt, wsum, scale, k,
                                     splits, tiles_per_seg, seg_out, gkth,
                                     out_v, out_i, idx_base, s);
    return (int)err;
}

// keys [S, nq, k] int64, each [s, row] sorted ascending -> the k smallest
// of each row: as (value, index) int32 pairs in out_v / out_i, INT32_MAX
// / -1 in empty slots; or, with keys_out [nq, k] (which may be keys' own
// list 0), as sorted keys, with each row's k-th value in kth_out [nq]
// when it is given.  The plan's shape is the launch's (S, nq, k).
extern "C" int avenir_topk_merge(const long long* keys, const MergePlan* plan,
                                 int* out_v, int* out_i, long long* keys_out,
                                 int* kth_out, void* stream) {
    if (!plan) return (int)cudaErrorInvalidValue;
    const MergePlan p = *plan;
    if (p.k < 1 || p.k > MAX_K || p.S < 1 || p.nq < 0 || p.warps < 1
        || p.rows < 1 || p.warps * p.rows > 32 || p.slots < 1
        || p.slots > p.S || p.rounds < 1 || (p.rounds > 1 && p.slots < 2)
        || p.slots + (long long)(p.rounds - 1) * (p.slots - 1) < p.S
        || (long long)p.smem != 8LL * p.slots * p.rows * p.k
        || (long long)p.grid * p.rows < p.nq || p.grid < 1
        || (!keys_out && (!out_v || !out_i)))
        return (int)cudaErrorInvalidValue;
    if (p.nq == 0) return 0;
    const int vec16 = p.k % 2 == 0
        && (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
    merge_kernel<<<p.grid, 32 * p.warps * p.rows, p.smem,
                   static_cast<cudaStream_t>(stream)>>>(
        keys, p, vec16, out_v, out_i, keys_out, kth_out);
    return (int)cudaGetLastError();
}

// The card's SM count and the shared memory a block may opt into
// (merge_plan's inputs); and merge_kernel allowed that much on the
// current device.
extern "C" int avenir_topk_device(int device, int* sms, int* smem_optin) {
    cudaError_t err = cudaDeviceGetAttribute(
        sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return (int)err;
}

extern "C" int avenir_topk_merge_prepare(int smem) {
    return (int)cudaFuncSetAttribute(
        merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" const char* avenir_topk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
