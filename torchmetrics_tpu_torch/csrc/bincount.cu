// Weighted bincount for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/bincount.py:_wbincount_pallas
// (body _wbincount_kernel, tile _onehot_partial), which one-hots each index
// tile against a bin tile and contracts it with the weight rows on the MXU.
// That one-hot matmul is a device of the TPU, not the specification; this
// kernel computes the same function directly:
//
//   out[k, c] = sum_n w[k, n] * [x[n] == c]   for 0 <= c < L, 0 <= k < K,
//
// K weight rows sharing one int32 index stream of length N; negative and
// out-of-range indices are dropped. The caller zeroes `out`.
//
// Bound: device-memory bytes. A call must read N*(4 + 4K) bytes of input and
// write K*L*4 bytes of output; with the wrapper's zero-fill it moves
// N*(4 + 4K) + 2*K*L*4 bytes, against 3.35 TB/s on an H100 SXM. One compare
// and K adds per index are far below the card's arithmetic rate.
//
// Regime A (K*L*4 <= 48 KB, e.g. L = 4 for the binary family, C*C = 100 or
// 361 for small confusion matrices, calibration's K = 3 rows): each block
// privatises a K x L float histogram in shared memory, adds its grid-stride
// share of the index stream with shared-memory atomics, and merges its
// non-zero bins into `out` with one global atomicAdd each. About two blocks
// per SM keep that merge small. At tiny L every warp hits a handful of
// addresses, so shared-memory atomics contend; that trade against the byte
// bound is left to a later change (warp-aggregated or per-warp histograms).
//
// Regime B (larger L, e.g. ImageNet's 1000 x 1000 confusion matrix, 10^6
// bins): the histogram does not fit on chip, so threads add grid-stride
// straight into `out` with global atomics; hits on 10^6 bins rarely collide.
//
// Exactness: with 0/1 weights every partial sum is an integer below 2^24, so
// float atomics give bit-exact counts in any order. Fractional weights are
// summed in an order that changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSharedBytes = 48 * 1024;
constexpr int64_t kSharedBlocksPerSM = 2;
constexpr int64_t kGlobalBlocksPerSM = 8;

__global__ void wbincount_shared(const int32_t* __restrict__ x, const float* __restrict__ w,
                                 float* __restrict__ out, int64_t n, int32_t length,
                                 int32_t k_rows) {
  extern __shared__ float hist[];
  const int32_t bins = length * k_rows;
  for (int32_t i = threadIdx.x; i < bins; i += blockDim.x) hist[i] = 0.0f;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t c = x[i];
    if (c >= 0 && c < length) {
      for (int32_t k = 0; k < k_rows; ++k) atomicAdd(&hist[k * length + c], w[k * n + i]);
    }
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < bins; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

__global__ void wbincount_global(const int32_t* __restrict__ x, const float* __restrict__ w,
                                 float* __restrict__ out, int64_t n, int64_t length,
                                 int32_t k_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t c = x[i];
    if (c >= 0 && c < length) {
      for (int32_t k = 0; k < k_rows; ++k) atomicAdd(&out[k * length + c], w[k * n + i]);
    }
  }
}

}  // namespace

// x: int32 (n,), w: float32 (k_rows, n), out: float32 (k_rows, length), all
// contiguous on the current device; launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int tm_wbincount(const void* x, const void* w, void* out, int64_t n, int64_t length,
                            int64_t k_rows, void* stream) {
  if (n <= 0 || length <= 0 || k_rows <= 0) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  const int64_t smem = k_rows * length * static_cast<int64_t>(sizeof(float));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int32_t*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  if (smem <= kSharedBytes) {
    const int64_t blocks = needed < kSharedBlocksPerSM * sms ? needed : kSharedBlocksPerSM * sms;
    wbincount_shared<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), s>>>(
        xi, wf, of, n, static_cast<int32_t>(length), static_cast<int32_t>(k_rows));
  } else {
    const int64_t blocks = needed < kGlobalBlocksPerSM * sms ? needed : kGlobalBlocksPerSM * sms;
    wbincount_global<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xi, wf, of, n, length, static_cast<int32_t>(k_rows));
  }
  return static_cast<int>(cudaGetLastError());
}
