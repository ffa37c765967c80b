// Class x feature x bin histogram for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the Pallas kernel avenir_tpu/ops/pallas_count.py::_make_kernel:
//   K1  kRawbin = false  (wide_feature_class_counts, pallas_count.py:134)
//   K2  kRawbin = true   (wide_feature_class_counts_rawbin, :145)
// The TPU kernel contracts bf16 one-hots on the MXU because scatters
// serialise on a TPU.  On Hopper integer atomics are cheap, so this kernel
// computes the same function directly:
//
//   out[c, f, b] += 1  for every row i and feature f with
//                      mask[i] != 0 (when a mask is given),
//                      0 <= c = y[i] < C, and 0 <= b < B, where
//                      b = trunc(x[i, f] / widths[f])  (K2)  or  b = x[i, f]  (K1).
//
// Bound: the kernel must read x, y and the mask once (n*(F*xbytes + ybytes
// + 1) bytes); at the H100's 3.35 TB/s that is 3.8 us for the churn
// training set and 79 us for the wide 2M x 32 int32 table.  Below that the
// limit is instructions and atomics per element.  The design:
//
// * Tiles.  x is cut into tiles of 8,192 int8 or 4,096 int32 codes (32 or
//   16 a thread), read as 16-byte vectors, neighbouring lanes on
//   neighbouring vectors; a block walks its tiles in a grid-stride loop.
//   At a tile's start the block stages, for every row the tile touches,
//   the row's table offset c*F*B (or -1 for a masked row or a class out of
//   range) in shared memory: y and the mask are read once per row, all
//   loads of a tile in flight together.  A thread then finds its first
//   element's (row, feature) with one reciprocal multiply (below) and
//   carries them in counters, so no division is left in the element loop.
//   The few codes before the first 16-byte boundary and after the last
//   whole vector are counted by one warp.
// * K2's division.  Each width w comes with m = floor((2^32 - 1) / w),
//   computed on the host (ops/histogram.py::k2_constants) and staged in
//   shared memory.  For |x| <= 2^31, q = umulhi(|x|, m) is floor(|x| / w)
//   or one less, and one compare-and-increment makes it exact; the sign is
//   put back after, so the bin truncates toward zero (Java), INT32_MIN
//   included.  Width 1 passes values through.
// * Tables, by size (the plan, ops/histogram.py::histogram_plan):
//     - block table  (fits one block's shared memory; churn: 192 cells,
//       wide: 32 KB): each block counts into its own copy;
//     - cluster      (fits two blocks' shared memory; the 256 KB case): a
//       thread-block cluster of two holds the table in slices, one per
//       block, and each count goes to the slice's owner as a
//       red.shared::cluster on the address mapa gives (distributed shared
//       memory); the cluster flushes the table once.  Clusters of 4 and 8
//       counted slower than global atomics on the H100;
//     - global       (larger): atomics straight to the output.
//   The plan also fixes the shared layout (the offsets of the staged rows
//   and of the table), which the kernel reads; the launch refuses a plan
//   whose layout does not hold what the kernel writes.
//   Every count is atomicAdd(cell, 1), which the card aggregates across
//   the lanes of a warp that hit the same cell (ATOMS.POPC.INC: the
//   hot-cell case costs one update per warp, not 32; per-warp copies of
//   the table measured no faster).  In a block table an element that adds
//   nothing goes to a trash cell past the table, so the atomic is not
//   branched around.  The shared routes flush each non-zero cell with one
//   global atomic.  Integer atomics are exact and independent of
//   order, so every route is bit-identical to the plain PyTorch version on
//   every run.
// * Per-call cost.  The wrapper computes the plan (route, grid, cluster,
//   shared bytes) once per shape and device and opts the kernels into the
//   card's shared memory once per device; a call is the launch alone.  The
//   grid is at most one tile a block, so fewer, fuller blocks zero and
//   flush their tables.
//
// The output is accumulated into, never overwritten: the caller owns it
// and zeroes it (or passes a running carry).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

// the launch plan, laid out as ops/histogram.py::_Plan (outside the
// anonymous namespace: the exported launch function takes it).  The shared
// layout is the plan's: stage and table are byte offsets into the block's
// dynamic shared memory, which holds smem bytes.
struct Plan {
  int64_t n;
  int32_t F, C, B, x_bytes, route, grid, cluster, slice, tile, stage, table, smem;
  uint32_t slice_m;
};

namespace {

constexpr int kThreads = 256;
// 64 registers a thread; ops/histogram.py BLOCKS_PER_SM matches it
constexpr int kMinBlocksPerSM = 4;

// the plan's routes (ops/histogram.py ROUTES)
enum Route : int { kBlockTable = 0, kCluster = 1, kGlobal = 2 };

struct Params {
  const void* x;
  const void* y;
  const uint8_t* mask;
  const uint2* wm;  // K2: (w, m) per feature
  int64_t n;
  int F, C, B;
  int32_t* out;
  int slice;
  uint32_t slice_m;
  int stage, table;  // shared byte offsets (the plan's)
};

// 16-byte vectors a thread counts per tile, and the codes a block counts
// per tile (ops/histogram.py TILE_ELEMS; the launch checks the plan's)
template <typename XT>
constexpr int kVectorsPerThread = sizeof(XT) == 1 ? 2 : 4;
template <typename XT>
constexpr int kTileOf = kThreads * kVectorsPerThread<XT> * (16 / sizeof(XT));

// floor(a / d) for a <= 2^31, d >= 1, with m = floor((2^32 - 1) / d)
__device__ __forceinline__ uint32_t udiv(uint32_t a, uint32_t d, uint32_t m) {
  uint32_t q = __umulhi(a, m);
  if (a - q * d >= d) ++q;
  return q;
}

// trunc(x / w) as K2 bins it (x itself for K1)
template <bool kRawbin>
__device__ __forceinline__ int bin_of(int x, const uint2* wm, int f) {
  if constexpr (!kRawbin) {
    return x;
  } else {
    const uint2 p = wm[f];
    const uint32_t a = x < 0 ? 0u - static_cast<uint32_t>(x) : static_cast<uint32_t>(x);
    const uint32_t q = udiv(a, p.x, p.y);
    return static_cast<int>(x < 0 ? 0u - q : q);
  }
}

// the table offset c*F*B of row r, or -1 where the row adds nothing
template <typename YT>
__device__ __forceinline__ int row_base(const Params& p, int64_t r) {
  const int c = static_cast<int>(__ldg(static_cast<const YT*>(p.y) + r));
  if (p.mask != nullptr && __ldg(p.mask + r) == 0) return -1;
  return c >= 0 && c < p.C ? c * p.F * p.B : -1;
}

template <int K>
__device__ __forceinline__ void count(int32_t* dst, int cell, const Params& p) {
  if constexpr (K == kCluster) {
    const uint32_t rank = udiv(static_cast<uint32_t>(cell), p.slice, p.slice_m);
    const uint32_t local = static_cast<uint32_t>(
        __cvta_generic_to_shared(dst + (cell - static_cast<int>(rank) * p.slice)));
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;" ::"r"(remote), "r"(1u));
  } else {
    atomicAdd(dst + cell, 1);
  }
}

template <typename XT, typename YT, bool kRawbin, int K>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
histogram_kernel(const Params p) {
  constexpr int V = 16 / sizeof(XT);  // codes a vector
  constexpr int U = kVectorsPerThread<XT>;
  constexpr int kTile = kTileOf<XT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = p.F, B = p.B, FB = F * B;
  const int cells = p.C * FB;
  const int tid = threadIdx.x;

  // shared memory, at the plan's offsets: [K2's (w, m) pairs][staged row
  // offsets, kTile / F + 3 of them][table]
  uint2* wm = reinterpret_cast<uint2*>(smem);
  if constexpr (kRawbin)
    for (int i = tid; i < F; i += kThreads) wm[i] = p.wm[i];
  int32_t* stage = reinterpret_cast<int32_t*>(smem + p.stage);
  int32_t* table = reinterpret_cast<int32_t*>(smem + p.table);
  // a block table ends in a trash cell, where the elements that add
  // nothing go: the atomic then needs no branch around it
  const int local_cells = K == kBlockTable ? cells + 1 : K == kCluster ? p.slice : 0;
  for (int i = tid; i < local_cells; i += kThreads) table[i] = 0;
  if constexpr (K == kCluster)
    cg::this_cluster().sync();  // no remote count before every slice is zeroed
  else
    __syncthreads();
  int32_t* dst = K == kGlobal ? p.out : table;

  const XT* x = static_cast<const XT*>(p.x);
  const int64_t total = p.n * F;
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / sizeof(XT);
  if (head > total) head = total;
  const int64_t nvec = (total - head) / V;
  const int64_t body_end = head + nvec * V;

  // the ragged ends, at most 2 * (V - 1) codes: one thread each
  if (blockIdx.x == 0 && tid < head + (total - body_end)) {
    const int64_t e = tid < head ? tid : body_end + (tid - head);
    const int64_t r = e / F;
    const int f = static_cast<int>(e - r * F);
    const int rb = row_base<YT>(p, r);
    const int b = bin_of<kRawbin>(static_cast<int>(x[e]), wm, f);
    if (rb >= 0 && b >= 0 && b < B) count<K>(dst, rb + f * B + b, p);
  }

  const int4* xv = reinterpret_cast<const int4*>(x + head);
  const int64_t ntiles = (nvec + kThreads * U - 1) / (kThreads * U);
  const uint32_t mF = 0xFFFFFFFFu / static_cast<uint32_t>(F);
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t v0 = t * kThreads * U;
    union {
      int4 raw;
      XT e[V];
    } vec[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t v = v0 + k * kThreads + tid;
      vec[k].raw = v < nvec ? __ldg(xv + v) : make_int4(0, 0, 0, 0);
    }
    const int64_t e0 = head + v0 * V;
    const int64_t row0 = e0 / F;
    const int f0 = static_cast<int>(e0 - row0 * F);
    const int64_t e_end = min(e0 + kTile, body_end);
    const int rows = static_cast<int>((e_end - 1) / F - row0) + 1;
    __syncthreads();  // the previous tile is done with the stage
    for (int i = tid; i <= rows; i += kThreads)
      stage[i] = i < rows ? row_base<YT>(p, row0 + i) : -1;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (v0 + k * kThreads + tid >= nvec) break;
      const uint32_t o = static_cast<uint32_t>(f0 + (k * kThreads + tid) * V);
      int rl = static_cast<int>(udiv(o, F, mF));
      int f = static_cast<int>(o) - rl * F;
      int fB = f * B;
      int rb = stage[rl];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int b = bin_of<kRawbin>(static_cast<int>(vec[k].e[j]), wm, f);
        const bool add = rb >= 0 && static_cast<unsigned>(b) < static_cast<unsigned>(B);
        if constexpr (K == kBlockTable)
          atomicAdd(dst + (add ? rb + fB + b : cells), 1);
        else if (add)
          count<K>(dst, rb + fB + b, p);
        if (kRawbin) ++f;
        fB += B;
        if (fB == FB) {
          f = 0;
          fB = 0;
          rb = stage[++rl];
        }
      }
    }
  }

  if constexpr (K == kGlobal) {
    return;
  } else if constexpr (K == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every remote count has landed
    const int lo = static_cast<int>(cluster.block_rank()) * p.slice;
    const int hi = min(cells, lo + p.slice);
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int32_t s = table[i - lo];
      if (s != 0) atomicAdd(p.out + i, s);
    }
  } else {
    __syncthreads();
    for (int i = tid; i < cells; i += kThreads) {
      const int32_t s = table[i];
      if (s != 0) atomicAdd(p.out + i, s);
    }
  }
}

template <typename XT, typename YT, bool kRawbin>
void* kernel_for(int route) {
  switch (route) {
    case kBlockTable:
      return reinterpret_cast<void*>(histogram_kernel<XT, YT, kRawbin, kBlockTable>);
    case kCluster:
      return reinterpret_cast<void*>(histogram_kernel<XT, YT, kRawbin, kCluster>);
    case kGlobal:
      return reinterpret_cast<void*>(histogram_kernel<XT, YT, kRawbin, kGlobal>);
  }
  return nullptr;
}

template <typename XT, typename YT>
void* kernel_for(bool rawbin, int route) {
  return rawbin ? kernel_for<XT, YT, true>(route) : kernel_for<XT, YT, false>(route);
}

void* kernel_for(int x_bytes, int y_bytes, bool rawbin, int route) {
  if (x_bytes == 1 && y_bytes == 1) return kernel_for<int8_t, int8_t>(rawbin, route);
  if (x_bytes == 1 && y_bytes == 4) return kernel_for<int8_t, int32_t>(rawbin, route);
  if (x_bytes == 4 && y_bytes == 1) return kernel_for<int32_t, int8_t>(rawbin, route);
  if (x_bytes == 4 && y_bytes == 4) return kernel_for<int32_t, int32_t>(rawbin, route);
  return nullptr;
}

}  // namespace

// The card's numbers that the plan needs: SMs, the shared memory a block
// may opt into, the shared memory of an SM.
extern "C" int avenir_histogram_device(int device, int* sms, int* smem_per_block,
                                       int* smem_per_sm) {
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(smem_per_block,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  return cudaDeviceGetAttribute(smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                device);
}

// Lets every kernel take up to `smem` bytes of dynamic shared memory on the
// current device.  Once per device, before the first launch there.
extern "C" int avenir_histogram_prepare(int smem) {
  for (int xb : {1, 4})
    for (int yb : {1, 4})
      for (int rawbin = 0; rawbin < 2; ++rawbin)
        for (int route : {kBlockTable, kCluster, kGlobal}) {
          const cudaError_t err = cudaFuncSetAttribute(
              kernel_for(xb, yb, rawbin, route),
              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
          if (err != cudaSuccess) return err;
        }
  return cudaSuccess;
}

namespace {

// Whether the plan's shared layout holds what the kernel writes there: the
// (w, m) pairs, kTile / F + 3 staged offsets, the route's table cells.
bool layout_fits(const Plan& p, bool rawbin) {
  const int tile = p.x_bytes == 1 ? kTileOf<int8_t> : kTileOf<int32_t>;
  const int64_t cells = static_cast<int64_t>(p.C) * p.F * p.B;
  const int64_t local = p.route == kBlockTable ? cells + 1 : p.route == kCluster ? p.slice : 0;
  return p.tile == tile && p.stage >= (rawbin ? 8LL * p.F : 0) && p.stage % 16 == 0 &&
         p.table - p.stage >= 4LL * (tile / p.F + 3) && p.smem - p.table >= 4 * local &&
         (p.route != kCluster || static_cast<int64_t>(p.slice) * p.cluster >= cells);
}

}  // namespace

// x: [n, F] int8 or int32 (x_bytes 1 or 4), row-major; y: [n] int8 or int32;
// mask: [n] bool or null; wm: K2's [F] (width, multiplier) pairs, or null
// for K1; out: int32 [C, F, B], accumulated into; plan: the shape (n, F,
// C, B, x_bytes) and its histogram_plan.  Launches on `stream` and does
// not synchronise.  Returns the launch's cudaError_t (0 on success); a plan
// whose layout does not fit the kernel is cudaErrorInvalidValue, and a
// cluster the card refuses is an error, never another route.
extern "C" int avenir_histogram(const void* x, const void* y, int y_bytes, const void* mask,
                                const void* wm, void* out, const Plan* plan, void* stream) {
  if (plan->n <= 0 || plan->F <= 0) return cudaSuccess;
  void* k = kernel_for(plan->x_bytes, y_bytes, wm != nullptr, plan->route);
  if (k == nullptr || !layout_fits(*plan, wm != nullptr)) return cudaErrorInvalidValue;
  Params p{x,
           y,
           static_cast<const uint8_t*>(mask),
           static_cast<const uint2*>(wm),
           plan->n,
           plan->F,
           plan->C,
           plan->B,
           static_cast<int32_t*>(out),
           plan->slice,
           plan->slice_m,
           plan->stage,
           plan->table};
  void* args[] = {&p};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(plan->grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(plan->smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  if (plan->route == kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(plan->cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelExC(&cfg, k, args);
}

extern "C" const char* avenir_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
