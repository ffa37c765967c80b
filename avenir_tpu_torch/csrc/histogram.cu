// Class x feature x bin histogram for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the Pallas kernel avenir_tpu/ops/pallas_count.py::_make_kernel:
//   K1  widths == nullptr  (wide_feature_class_counts, pallas_count.py:134)
//   K2  widths != nullptr  (wide_feature_class_counts_rawbin, :145)
// The TPU kernel contracts bf16 one-hots on the MXU because scatters
// serialise on a TPU.  On Hopper integer atomics are cheap, so this kernel
// computes the same function directly:
//
//   out[c, f, b] += 1  for every row i and feature f with
//                      mask[i] != 0 (when a mask is given),
//                      0 <= c = y[i] < C, and 0 <= b < B, where
//                      b = x[i, f] / widths[f]  (K2)  or  b = x[i, f]  (K1).
//
// K2's division is C++ integer division, which truncates toward zero: that
// is exactly the Java bucket semantics of ops.counting.bin_raw, negative
// raw values included.  Width 1 passes values through.
//
// Design: a grid-stride loop over the n*F (row, feature) elements, so that
// neighbouring threads read neighbouring bytes of the row-major x.  Each
// block keeps a private C*F*B int32 table in dynamic shared memory (opt-in
// above 48 KB), adds to it with shared atomicAdd, and flushes its non-zero
// cells to the output with one global atomicAdd each.  When the table does
// not fit in a block's shared memory, the same kernel adds straight to the
// output in global memory.  Integer atomics are exact and independent of
// order, so the result is bit-identical to the plain PyTorch version on
// every run.  The output is accumulated into, never overwritten: the caller
// owns it and zeroes it (or passes a running carry).
//
// Bound: the kernel must read n*(F+1)*itemsize bytes (x and y), plus n
// bytes of mask, once; at the H100's 3.35 TB/s that is 3.8 us for the
// churn training set (1.6M rows, F=6, int8, masked) and 79 us for the
// wide shape (2M rows, F=32, int32, masked).  The likely real limit is
// shared-atomic contention when C*F*B is small (churn: 2 classes x 6
// features x 16 bins = 192 cells), where many lanes of a warp hit the
// same address.
// Warp-aggregated or per-warp sub-histograms are the next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// The most dynamic shared memory one block may opt into on sm_90.
constexpr size_t kMaxSharedBytes = 232448;

template <typename XT, typename YT, bool kShared>
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const XT* __restrict__ x, const YT* __restrict__ y,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ widths, int64_t n, int F, int C,
                 int B, int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];
  const int cells = C * F * B;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) table[i] = 0;
    __syncthreads();
  }
  int32_t* dst = kShared ? table : out;
  const int64_t total = n * F;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t row = e / F;
    const int f = static_cast<int>(e - row * F);
    if (mask != nullptr && mask[row] == 0) continue;
    const int c = static_cast<int>(y[row]);
    if (c < 0 || c >= C) continue;
    int b = static_cast<int>(x[e]);
    if (widths != nullptr) b /= widths[f];  // truncates toward zero
    if (b < 0 || b >= B) continue;
    atomicAdd(&dst[(c * F + f) * B + b], 1);
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const int32_t v = table[i];
      if (v != 0) atomicAdd(&out[i], v);
    }
  }
}

template <typename XT, typename YT, bool kShared>
cudaError_t launch_as(const void* x, const void* y, const void* mask,
                      const void* widths, int64_t n, int F, int C, int B,
                      void* out, cudaStream_t stream) {
  auto kernel = histogram_kernel<XT, YT, kShared>;
  const size_t smem = kShared ? static_cast<size_t>(C) * F * B * sizeof(int32_t) : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  // Every block flushes its whole table, so launch no more blocks than can
  // be resident at once; the grid-stride loop covers the rest of the rows.
  const int64_t needed = (n * F + kThreads - 1) / kThreads;
  int64_t blocks = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  if (needed < blocks) blocks = needed;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const YT*>(y),
      static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(widths), n, F, C,
      B, static_cast<int32_t*>(out));
  return cudaGetLastError();
}

template <typename XT, typename YT>
cudaError_t launch(const void* x, const void* y, const void* mask, const void* widths,
                   int64_t n, int F, int C, int B, void* out, cudaStream_t stream) {
  const size_t table_bytes = static_cast<size_t>(C) * F * B * sizeof(int32_t);
  if (table_bytes <= kMaxSharedBytes)
    return launch_as<XT, YT, true>(x, y, mask, widths, n, F, C, B, out, stream);
  return launch_as<XT, YT, false>(x, y, mask, widths, n, F, C, B, out, stream);
}

}  // namespace

// x: [n, F] int8 or int32 (x_bytes 1 or 4), row-major; y: [n] int8 or int32;
// mask: [n] bool or null; widths: [F] int32 (all >= 1) or null; out: int32
// [C, F, B], accumulated into.  Launches on `stream` and does not
// synchronise.  Returns the launch's cudaError_t (0 on success).
extern "C" int avenir_histogram(const void* x, int x_bytes, const void* y, int y_bytes,
                                const void* mask, const void* widths, long long n,
                                int F, int C, int B, void* out, void* stream) {
  if (n <= 0 || F <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bytes == 1 && y_bytes == 1)
    return launch<int8_t, int8_t>(x, y, mask, widths, n, F, C, B, out, s);
  if (x_bytes == 1 && y_bytes == 4)
    return launch<int8_t, int32_t>(x, y, mask, widths, n, F, C, B, out, s);
  if (x_bytes == 4 && y_bytes == 1)
    return launch<int32_t, int8_t>(x, y, mask, widths, n, F, C, B, out, s);
  if (x_bytes == 4 && y_bytes == 4)
    return launch<int32_t, int32_t>(x, y, mask, widths, n, F, C, B, out, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* avenir_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
