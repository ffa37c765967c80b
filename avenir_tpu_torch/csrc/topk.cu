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
// ascending lexicographic order, lowest candidate index first on ties.
// Candidates at or past nt are masked in the kernel; nothing is padded.
//
// Bound on the H100 (SXM, 700 W): the cross term is 2*nq*nt*F FLOPs
// (manhattan: 3*nq*nt*F operations) on the CUDA cores, at the float32 rate
// of ~67 TFLOP/s: TF32 and the tensor cores are barred, because their
// rounding would move distances across the int-scale boundary that the
// reference's +-1 unit contract allows.  The bytes (each input read
// once, k pairs written per row) are far smaller, so the kernel is bound
// by operations.
//
// Design (simple and exact first; faster staging is later work):
//   - one block of 256 threads owns QB=32 query rows and loops over the
//     candidate axis in tiles of TB=128 rows; the loop takes the place of
//     the TPU's sequential grid axis, so there is no row cap and no
//     segment merge;
//   - each tile's feature columns are staged through shared memory in
//     chunks of FK=32; each thread keeps a 4x4 register micro-tile of the
//     float32 cross term (or the manhattan sum), accumulated with FMA on
//     the CUDA cores; q2 and t2 are computed here, from the same staged
//     values;
//   - warp w owns rows w, w+8, w+16, w+24 and holds all 128 candidates of
//     those rows in registers, so selection needs no distance tile in
//     shared memory: each warp keeps, per row, a sorted list of the k
//     smallest unique int64 keys (value << 32 | index) in shared memory,
//     guarded by the current k-th key, so almost every candidate is
//     rejected by one compare; a candidate below it is inserted by the
//     whole warp (ballot for the position, one shift);
//   - the keys are unique and the list is exact, so no row can come out
//     wrong and the kernel never flags a row as suspect.  The wrapper
//     keeps the suspect flag (all false) for the reference's contract.
//
// The selection lists live in dynamic shared memory (QB * k * 8 bytes),
// so the block needs more than 48 KB for large k: the entry point raises
// the kernel's dynamic shared-memory limit once.
//
// C entry points (plain C interface, loaded with ctypes):
//   avenir_topk(...)             launches on the given stream and returns
//                                cudaGetLastError() after the launch;
//   avenir_topk_error_string(e)  the CUDA error string.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 32;          // query rows per block
constexpr int TB = 128;         // candidate rows per tile
constexpr int FK = 32;          // feature columns per shared-memory stage
constexpr int THREADS = 256;    // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = QB / WARPS; // rows per warp (4)
constexpr int CPL = TB / 32;    // candidate columns per lane (4)
constexpr int MAX_K = 64;
constexpr int MAX_CAT = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SENT = 0x7fffffffffffffffLL;

__host__ __device__ constexpr size_t smem_bytes(int k) {
    return sizeof(long long) * QB * k                       // lists
           + sizeof(float) * (FK * (QB + 1) + FK * (TB + 1)  // qs, ts
                              + WARPS * TB + QB)             // t2 parts, q2
           + sizeof(int) * (QB * MAX_CAT + TB * (MAX_CAT + 1));
}

// Insert ``key`` (known to be below list[k-1]) into the warp's sorted
// list of k keys: every lane holds entries lane and lane+32.
__device__ __forceinline__ void insert_key(long long* list, int k,
                                           long long key, int lane) {
    const long long e0 = lane < k ? list[lane] : SENT;
    const long long e1 = lane + 32 < k ? list[lane + 32] : SENT;
    const int pos = __popc(__ballot_sync(FULL, e0 < key))
                    + __popc(__ballot_sync(FULL, e1 < key));
    __syncwarp();
    if (lane >= pos && lane + 1 < k) list[lane + 1] = e0;
    if (lane + 32 >= pos && lane + 33 < k) list[lane + 33] = e1;
    if (lane == 0) list[pos] = key;
    __syncwarp();
}

template <bool EUCLID>
__global__ void __launch_bounds__(THREADS)
topk_kernel(const float* __restrict__ qn, const float* __restrict__ tn,
            int F, const int* __restrict__ qc, const int* __restrict__ tc,
            const float* __restrict__ cat_w, int Cc, int nq, int nt,
            float wsum, float scale, int k,
            int* __restrict__ out_v, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    long long* lists = reinterpret_cast<long long*>(smem);   // [QB][k]
    float* qs = reinterpret_cast<float*>(lists + QB * k);    // [FK][QB+1]
    float* ts = qs + FK * (QB + 1);                          // [FK][TB+1]
    float* t2part = ts + FK * (TB + 1);                      // [WARPS][TB]
    float* q2s = t2part + WARPS * TB;                        // [QB]
    int* qcs = reinterpret_cast<int*>(q2s + QB);             // [QB][MAX_CAT]
    int* tcs = qcs + QB * MAX_CAT;                           // [TB][MAX_CAT+1]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long q0 = (long long)blockIdx.x * QB;

    for (int i = tid; i < QB * k; i += THREADS) lists[i] = SENT;
    for (int i = tid; i < QB * Cc; i += THREADS) {
        const int r = i / Cc, c = i % Cc;
        qcs[r * MAX_CAT + c] = q0 + r < nq ? qc[(q0 + r) * Cc + c] : 0;
    }
    if (EUCLID) {
        // q2 of the block's rows: lane-strided over F, then a fixed
        // shuffle tree, so the order is the same in every run
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int r = warp + WARPS * i;
            float s = 0.f;
            if (q0 + r < nq)
                for (int f = lane; f < F; f += 32) {
                    const float v = qn[(q0 + r) * F + f];
                    s = fmaf(v, v, s);
                }
#pragma unroll
            for (int off = 16; off; off >>= 1)
                s = __fadd_rn(s, __shfl_xor_sync(FULL, s, off));
            if (lane == 0) q2s[r] = s;
        }
    }
    __syncthreads();

    long long thr[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) thr[i] = SENT;

    for (long long t0 = 0; t0 < nt; t0 += TB) {
        float acc[RPW][CPL];
        float t2p[CPL];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
            for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) t2p[j] = 0.f;

        for (int f0 = 0; f0 < F; f0 += FK) {
            for (int i = tid; i < QB * FK; i += THREADS) {
                const int r = i / FK, f = i % FK;
                const long long gq = q0 + r;
                const int gf = f0 + f;
                qs[f * (QB + 1) + r] =
                    (gq < nq && gf < F) ? qn[gq * F + gf] : 0.f;
            }
            for (int i = tid; i < TB * FK; i += THREADS) {
                const int r = i / FK, f = i % FK;
                const long long gt = t0 + r;
                const int gf = f0 + f;
                ts[f * (TB + 1) + r] =
                    (gt < nt && gf < F) ? tn[gt * F + gf] : 0.f;
            }
            __syncthreads();
            if (EUCLID) {
                // t2 partial sums: warp w takes the columns f = w (mod 8)
                for (int f = warp; f < FK; f += WARPS)
#pragma unroll
                    for (int j = 0; j < CPL; ++j) {
                        const float v = ts[f * (TB + 1) + lane + 32 * j];
                        t2p[j] = fmaf(v, v, t2p[j]);
                    }
            }
#pragma unroll 4
            for (int f = 0; f < FK; ++f) {
                float a[RPW], b[CPL];
#pragma unroll
                for (int i = 0; i < RPW; ++i)
                    a[i] = qs[f * (QB + 1) + warp + WARPS * i];
#pragma unroll
                for (int j = 0; j < CPL; ++j)
                    b[j] = ts[f * (TB + 1) + lane + 32 * j];
#pragma unroll
                for (int i = 0; i < RPW; ++i)
#pragma unroll
                    for (int j = 0; j < CPL; ++j) {
                        if (EUCLID)
                            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
                        else
                            acc[i][j] = __fadd_rn(
                                acc[i][j], fabsf(__fsub_rn(a[i], b[j])));
                    }
            }
            __syncthreads();
        }

        for (int i = tid; i < TB * Cc; i += THREADS) {
            const int r = i / Cc, c = i % Cc;
            tcs[r * (MAX_CAT + 1) + c] =
                t0 + r < nt ? tc[(t0 + r) * Cc + c] : 0;
        }
        if (EUCLID) {
#pragma unroll
            for (int j = 0; j < CPL; ++j)
                t2part[warp * TB + lane + 32 * j] = t2p[j];
        }
        __syncthreads();

        float t2[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
            t2[j] = 0.f;
            if (EUCLID) {
                t2[j] = t2part[lane + 32 * j];
                for (int w = 1; w < WARPS; ++w)
                    t2[j] = __fadd_rn(t2[j], t2part[w * TB + lane + 32 * j]);
            }
        }

#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int row = warp + WARPS * i;
            if (q0 + row >= nq) continue;           // uniform in the warp
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
                const int cl = lane + 32 * j;
                const long long col = t0 + cl;
                float parts = 0.f;
                if (F) {
                    if (EUCLID)
                        parts = fmaxf(__fsub_rn(__fadd_rn(q2s[row], t2[j]),
                                                __fmul_rn(2.f, acc[i][j])),
                                      0.f);
                    else
                        parts = acc[i][j];
                }
                if (Cc) {
                    float ca = 0.f;
                    for (int c = 0; c < Cc; ++c) {
                        const float term =
                            qcs[row * MAX_CAT + c] != tcs[cl * (MAX_CAT + 1) + c]
                                ? cat_w[c] : 0.f;
                        ca = c ? __fadd_rn(ca, term) : term;
                    }
                    parts = F ? __fadd_rn(parts, ca) : ca;
                }
                float d = __fdiv_rn(parts, wsum);
                if (EUCLID) d = __fsqrt_rn(d);
                d = fminf(__fmul_rn(d, scale), 2147483392.0f);
                const long long key =
                    (long long)(int)d * 4294967296LL + col;
                const bool cand = col < nt && key < thr[i];
                unsigned m = __ballot_sync(FULL, cand);
                long long* list = lists + row * k;
                while (m) {
                    const int src = __ffs(m) - 1;
                    m &= m - 1;
                    const long long kk = __shfl_sync(FULL, key, src);
                    if (kk < thr[i]) {
                        insert_key(list, k, kk, lane);
                        thr[i] = list[k - 1];
                    }
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
        const int row = warp + WARPS * i;
        const long long gq = q0 + row;
        if (gq >= nq) continue;
        for (int j = lane; j < k; j += 32) {
            const long long key = lists[row * k + j];
            out_v[gq * k + j] = key == SENT ? 0x7fffffff : (int)(key >> 32);
            out_i[gq * k + j] = key == SENT ? -1 : (int)(key & 0xffffffffLL);
        }
    }
}

template <bool EUCLID>
cudaError_t allow_smem() {
    static cudaError_t done = cudaFuncSetAttribute(
        topk_kernel<EUCLID>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_K));
    return done;
}

}  // namespace

extern "C" int avenir_topk(const float* qn, const float* tn, int F,
                           const int* qc, const int* tc, const float* cat_w,
                           int Cc, int nq, int nt, float wsum, float scale,
                           int k, int euclidean, int* out_v, int* out_i,
                           void* stream) {
    if (k < 1 || k > MAX_K || Cc < 0 || Cc > MAX_CAT || F < 0 || nq < 0
        || nt < 0)
        return (int)cudaErrorInvalidValue;
    if (nq == 0) return 0;
    cudaError_t err = euclidean ? allow_smem<true>() : allow_smem<false>();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((nq + QB - 1) / QB));
    const size_t smem = smem_bytes(k);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (euclidean)
        topk_kernel<true><<<grid, THREADS, smem, s>>>(
            qn, tn, F, qc, tc, cat_w, Cc, nq, nt, wsum, scale, k, out_v,
            out_i);
    else
        topk_kernel<false><<<grid, THREADS, smem, s>>>(
            qn, tn, F, qc, tc, cat_w, Cc, nq, nt, wsum, scale, k, out_v,
            out_i);
    return (int)cudaGetLastError();
}

extern "C" const char* avenir_topk_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
