// Weighted and weightless bincount for Hopper (sm_90a), bound to Python with
// ctypes.
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
// out-of-range indices are dropped. With w null (weightless, K = 1) every
// in-range index counts 1 into an int64 output: the fused classification
// counts fold their ignore_index mask into the index (a masked sample is -1)
// instead of carrying a 0/1 weight row. The entry point zeroes `out` on the
// stream (cudaMemsetAsync), then counts.
//
// Bound: device-memory bytes. A call must read 4N bytes of indices, 4KN of
// weights (none weightless) and write 4KL bytes of float32 counts, or 8L of
// int64 ones weightless (the zero-fill writes them once more): 0.0100 ms weightless and 0.0184 ms with one weight row at
// Cityscapes' 8.4M pixels, at 3.35 TB/s on an H100 SXM. One compare and K
// adds per index are far below the card's arithmetic rate.
//
// Regime A (the K x L histogram fits in shared memory: every confusion
// matrix up to about 220 classes, the binary family's 4 bins, calibration's
// 3 x 15): one block of 1,024 threads per SM, one wave. Each warp adds into
// its own copy of the histogram (as many copies as fit, up to 32), so warps
// never contend; the copies are summed at the end of the block and each
// non-zero bin goes to `out` with one global atomic (132 x 361 at
// Cityscapes, not one per index). Weightless counts are integer shared adds
// and integer global adds;
// weighted adds skip zero weights. The smallest histograms aggregate within a
// warp first: with one row and L <= 4 (the binary family's 4 bins), where
// every lane of a warp would hit the same few addresses, each thread tallies
// every bin in registers and the warp sums them by shuffles at the end.
//
// Regime B (larger, e.g. ImageNet's 1000 x 1000 confusion matrix, 10^6
// bins): threads add straight into `out` with global atomics; hits on 10^6
// bins rarely collide.
//
// Loads: indices as int4 and weights as float4 (streaming, evict-first),
// four 16-byte index loads in flight a thread, a scalar tail; a misaligned
// pointer, or K > 1 weight rows with N not a multiple of 4, takes the scalar
// loop.
//
// Exactness: weightless counts are integers end to end: uint32 tallies a
// block, added into an int64 output with 64-bit integer atomics, so they are
// exact at any N (a float32 sum of ones stops at 2^24 = 16,777,216). Weighted
// rows are float32 atomics; 0/1 weights stay exact while a bin holds fewer
// than 2^24 events, and fractional weights are summed in an order that
// changes from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include <tuple>
#include <type_traits>

namespace {

constexpr int kBlockThreads = 1024;  // regime A: one block of 32 warps a SM
constexpr int kWarps = kBlockThreads / 32;
constexpr int kGlobalThreads = 256;  // regime B
constexpr int64_t kGlobalBlocksPerSM = 8;
constexpr int64_t kSharedLimit = 192 * 1024;  // dynamic shared memory a block may take
constexpr int kUnroll = 4;                    // 16-byte index loads in flight a thread
constexpr int kMaxDevices = 64;

__device__ __forceinline__ bool in_range(int32_t c, int32_t length) {
  return static_cast<uint32_t>(c) < static_cast<uint32_t>(length);
}

// kShared: regime A (per-warp copies in shared memory), else regime B.
// kWeighted: w holds k_rows rows of n weights; else w is null and k_rows 1.
// kVec: x (and w) are 16-byte aligned, and n % 4 == 0 when k_rows > 1.
// kRegBins (4: regime A, k_rows 1, length <= 4; else 0): each thread
// tallies every bin in registers, and a warp sums them by shuffles at the
// end. Otherwise one shared (regime A) or global (regime B) atomic an
// in-range index and row.
template <bool kShared, bool kWeighted, bool kVec, int kRegBins>
__global__ void __launch_bounds__(kShared ? kBlockThreads : kGlobalThreads)
    wbincount(const int32_t* __restrict__ x, const float* __restrict__ w, void* __restrict__ out_any, int64_t n,
              int32_t length, int32_t k_rows, int32_t copies) {
  static_assert(kShared || kRegBins == 0, "register tallies are for regime A");
  extern __shared__ __align__(16) uint32_t smem[];
  const int32_t bins = kShared ? length * k_rows : 0;
  const int lane = threadIdx.x & 31;
  // weighted: float32 (k_rows, length); weightless: int64 (length,)
  float* out = static_cast<float*>(out_any);
  unsigned long long* iout = static_cast<unsigned long long*>(out_any);
  float* fhist = out;
  uint32_t* uhist = smem;
  if constexpr (kShared) {
    for (int32_t i = threadIdx.x; i < bins * copies; i += blockDim.x) smem[i] = 0u;
    __syncthreads();
    const int32_t mine = ((threadIdx.x >> 5) % copies) * bins;
    fhist = reinterpret_cast<float*>(smem) + mine;
    uhist = smem + mine;
  }
  using Tally = typename std::conditional<kWeighted, float, uint32_t>::type;
  Tally reg[kRegBins > 0 ? kRegBins : 1] = {};

  // index c with weight v of row k (v is 1 weightless)
  auto take = [&](int32_t c, int32_t k, float v) {
    if constexpr (kRegBins > 0) {
      const int32_t key = in_range(c, length) ? c : -1;
#pragma unroll
      for (int b = 0; b < kRegBins; ++b) {
        if constexpr (kWeighted) {
          reg[b] += key == b ? v : 0.0f;
        } else {
          reg[b] += key == b ? 1u : 0u;
        }
      }
    } else if (in_range(c, length)) {
      if constexpr (kWeighted) {
        if (v != 0.0f) atomicAdd(fhist + static_cast<int64_t>(k) * length + c, v);
      } else if constexpr (kShared) {
        atomicAdd(uhist + c, 1u);
      } else {
        atomicAdd(iout + c, 1ull);
      }
    }
  };

  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t start = 0;
  if constexpr (kVec) {
    const int64_t n4 = n >> 2;
    const int4* x4 = reinterpret_cast<const int4*>(x);
    // the loop test is the same for every lane of a warp (j0 - lane is the
    // warp's first index), so a warp stays converged for the final shuffles
    for (int64_t j0 = tid; j0 - lane < n4; j0 += stride * kUnroll) {
      int4 xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + u * stride;
        xv[u] = j < n4 ? __ldcs(x4 + j) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int4 c = xv[u];
        if constexpr (kWeighted) {
          const int64_t j = j0 + u * stride;
          if (in_range(c.x, length) || in_range(c.y, length) || in_range(c.z, length) || in_range(c.w, length)) {
            for (int32_t k = 0; k < k_rows; ++k) {
              const float4 v = __ldcs(reinterpret_cast<const float4*>(w + k * n) + j);
              take(c.x, k, v.x);
              take(c.y, k, v.y);
              take(c.z, k, v.z);
              take(c.w, k, v.w);
            }
          }
        } else {
          take(c.x, 0, 1.0f);
          take(c.y, 0, 1.0f);
          take(c.z, 0, 1.0f);
          take(c.w, 0, 1.0f);
        }
      }
    }
    start = n4 << 2;  // fewer than four left, for the first warp's lanes
  }
  for (int64_t i = start + tid; i - lane < n; i += stride) {
    const int32_t c = i < n ? __ldcs(x + i) : -1;
    if constexpr (kWeighted) {
      if (in_range(c, length))
        for (int32_t k = 0; k < k_rows; ++k) take(c, k, __ldcs(w + k * n + i));
    } else {
      take(c, 0, 1.0f);
    }
  }

  if constexpr (kShared) {
    if constexpr (kRegBins > 0) {  // the warp's tallies, summed by shuffles, into its copy
#pragma unroll
      for (int b = 0; b < kRegBins; ++b) {
        Tally t = reg[b];
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1) t += __shfl_xor_sync(0xffffffffu, t, offset);
        if (lane == 0 && b < length && t != Tally(0)) {
          if constexpr (kWeighted) {
            atomicAdd(fhist + b, t);
          } else {
            atomicAdd(uhist + b, t);
          }
        }
      }
    }
    __syncthreads();
    for (int32_t b = threadIdx.x; b < bins; b += blockDim.x) {
      if constexpr (kWeighted) {
        float s = 0.0f;
        for (int32_t cp = 0; cp < copies; ++cp) s += reinterpret_cast<const float*>(smem)[cp * bins + b];
        if (s != 0.0f) atomicAdd(out + b, s);
      } else {
        uint32_t s = 0u;
        for (int32_t cp = 0; cp < copies; ++cp) s += smem[cp * bins + b];
        if (s != 0u) atomicAdd(iout + b, static_cast<unsigned long long>(s));
      }
    }
  }
}

template <bool kShared, bool kWeighted, bool kVec, int kRegBins>
cudaError_t launch(const int32_t* x, const float* w, void* out, int64_t n, int32_t length, int32_t k_rows,
                   int32_t copies, int64_t blocks, int device, cudaStream_t s) {
  auto kernel = wbincount<kShared, kWeighted, kVec, kRegBins>;
  size_t smem = 0;
  if constexpr (kShared) {
    smem = static_cast<size_t>(copies) * length * k_rows * sizeof(uint32_t);
    // raise the dynamic shared-memory cap once per device and instance
    static bool raised[kMaxDevices] = {};
    if (smem > 48 * 1024 && device < kMaxDevices && !raised[device]) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSharedLimit));
      if (err != cudaSuccess) return err;
      raised[device] = true;
    }
  }
  kernel<<<static_cast<unsigned>(blocks), kShared ? kBlockThreads : kGlobalThreads, smem, s>>>(x, w, out, n, length,
                                                                                              k_rows, copies);
  return cudaGetLastError();
}

template <bool kShared, bool kWeighted, int kRegBins = 0>
cudaError_t launch_vec(bool vec, const int32_t* x, const float* w, void* out, int64_t n, int32_t length,
                       int32_t k_rows, int32_t copies, int64_t blocks, int device, cudaStream_t s) {
  auto body = vec ? launch<kShared, kWeighted, true, kRegBins> : launch<kShared, kWeighted, false, kRegBins>;
  return body(x, w, out, n, length, k_rows, copies, blocks, device, s);
}

cudaError_t run(const int32_t* x, const float* w, void* out, int64_t n, int64_t length, int64_t k_rows, int device,
                cudaStream_t s) {
  const bool weighted = w != nullptr;
  const size_t item = weighted ? sizeof(float) : sizeof(int64_t);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(k_rows * length) * item, s);
  if (err != cudaSuccess || n <= 0) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (!weighted || (reinterpret_cast<uintptr_t>(w) % 16 == 0 && (k_rows == 1 || n % 4 == 0)));
  const int32_t len = static_cast<int32_t>(length);
  const int32_t k = static_cast<int32_t>(k_rows);

  // regime A: the most per-warp copies (a power of two up to one a warp)
  // that fit in kSharedLimit
  const int64_t hist_bytes = k_rows * length * static_cast<int64_t>(sizeof(uint32_t));
  int32_t copies = 0;
  if (hist_bytes <= kSharedLimit) {
    copies = kWarps;
    while (copies > 1 && copies * hist_bytes > kSharedLimit) copies >>= 1;
  }
  if (copies > 0) {
    // one wave, with at least four indices a thread
    int64_t blocks = (n + kBlockThreads * 4 - 1) / (kBlockThreads * 4);
    if (blocks > sms) blocks = sms;
    const auto args = std::make_tuple(vec, x, w, out, n, len, k, copies, blocks, device, s);
    if (k_rows == 1 && length <= 4)
      return weighted ? std::apply(launch_vec<true, true, 4>, args) : std::apply(launch_vec<true, false, 4>, args);
    return weighted ? std::apply(launch_vec<true, true>, args) : std::apply(launch_vec<true, false>, args);
  }
  int64_t blocks = (n + kGlobalThreads * 4 - 1) / (kGlobalThreads * 4);
  if (blocks > kGlobalBlocksPerSM * sms) blocks = kGlobalBlocksPerSM * sms;
  if (weighted) return launch_vec<false, true>(vec, x, w, out, n, len, k, 1, blocks, device, s);
  return launch_vec<false, false>(vec, x, w, out, n, len, k, 1, blocks, device, s);
}

}  // namespace

// x: int32 (n,); w: float32 (k_rows, n), or null for a weightless count
// (k_rows must then be 1); out: float32 (k_rows, length), or int64 (1,
// length) weightless; all contiguous on
// CUDA device `device`. Zeroes `out` and counts into it on `stream`, a
// stream of that device; returns the first failing call's cudaError_t (0 on
// success).
extern "C" int tm_wbincount(const void* x, const void* w, void* out, int64_t n, int64_t length, int64_t k_rows,
                            int device, void* stream) {
  if (length <= 0 || k_rows <= 0) return 0;
  if ((w == nullptr && k_rows != 1) || length > INT32_MAX || k_rows > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run(static_cast<const int32_t*>(x), static_cast<const float*>(w), out, n, length, k_rows,
            device, static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t restore = cudaSetDevice(current);
    if (err == cudaSuccess) err = restore;
  }
  return static_cast<int>(err);
}
