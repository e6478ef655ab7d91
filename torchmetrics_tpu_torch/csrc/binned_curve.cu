// Threshold-binned confusion counts for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/binned_curve.py:_binned_counts_pallas
// (body _binned_kernel, tile _binned_tile), which materialises a
// (TILE_N, T_pad) compare tile in VMEM and keeps its (8, T_pad) output block
// resident across a sequential grid. Neither carries over: Hopper blocks run
// unordered, and an N x T compare does T times the work this function needs.
// This kernel computes the same counts from the bucket formulation of the
// JAX package's own plain body (_binned_counts_searchsorted):
//
//   out[t, i, j] = sum_n valid_n * [target_n = i] * [(pred_n >= thr_t) = j]
//
// for T thresholds in the caller's order (any order, duplicates allowed),
// with the target weights of that body: a valid sample adds target_n to the
// positive row and 1 - target_n to the negative row.
//
//   1. The caller sorts the thresholds (stable; a metric once, when it is
//      built or moved) and passes the sorted values and the permutation.
//   2. Each thread binary-searches a sample's score in the sorted thresholds
//      and finds its bucket k = #{t : thr_sorted[t] <= pred}, 0 <= k <= T. A
//      NaN score compares false with every threshold, so it lands in bucket 0
//      and counts as predicted negative at every threshold, as in both JAX
//      bodies.
//   3. It adds the sample into a per-warp sub-histogram of 2 x (T+1) int32
//      counts in shared memory (regime A); each block then merges its
//      non-zero bins into a global int64 histogram with one atomic each.
//      Where even one sub-histogram and the thresholds overflow the 227 KB
//      of shared memory (T above about 19,000), threads search the sorted
//      thresholds in device memory (where L2 holds them) and add straight
//      into the global histogram (regime B), where hits on that many bins
//      rarely collide.
//   4. Suffix sums over buckets (pred >= thr_sorted[t] exactly for buckets
//      k > t) write the (T, 2, 2) int64 counts in the caller's threshold
//      order. One block scans up to 4,096 buckets (four a thread); above
//      that, three launches spread the scan over the card (tile sums, one
//      block of carries, tile writes): a single block moves only some 10 GB/s,
//      too little for the 2.8 MB of a 50,000-threshold suffix sum.
//
// Counts are integers end to end, so they are exact at any N; the Pallas
// kernel sums in float32 and is exact only up to 2^24 valid samples a call.
//
// Bound: device-memory bytes. A call must read 9 bytes a sample (float32
// score, int32 target, bool mask) and the T thresholds, and write 32 bytes
// a threshold; the binary search is log2(T+1) compares a sample, far below
// the card's compare rate. What the design does about the bytes: each
// sample is read once, coalesced, with four independent samples in flight
// per thread to hide load latency; the (T, N) compare never exists. The
// cost it does not remove is shared-memory atomic contention when most
// scores fall into a few buckets; per-warp sub-histograms spread it eight
// ways.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kGlobalThreads = 1024;  // regime B
constexpr int kFinalizeThreads = 1024;
constexpr int kStrip = 4;  // buckets a suffix-sum thread owns in its tile
constexpr int32_t kTile = kFinalizeThreads * kStrip;  // buckets a suffix-sum block owns
constexpr int64_t kMaxSharedBytes = 227 * 1024;
constexpr int64_t kSamplesPerBlock = 4096;  // at least this many samples a block, to amortise its merge

__device__ __forceinline__ int bucket_of(const float* thr, int len_t, float p) {
  // upper bound: the first index whose threshold is > p (NaN p: 0)
  int lo = 0;
  int hi = len_t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The histogram pass. Regime A (kSharedHist): sorted thresholds and `subs`
// sub-histograms of 2 x (T+1) int32 counts in shared memory, warp w adding
// into sub-histogram w % subs, each block merging its non-zero bins into
// `hist` at the end. Regime B: the thresholds searched in device memory and
// counts added straight into `hist`.
template <bool kSharedHist>
__global__ void __launch_bounds__(kGlobalThreads) binned_hist(const float* __restrict__ preds,
                                                              const int32_t* __restrict__ target,
                                                              const uint8_t* __restrict__ valid,
                                                              const float* __restrict__ thr_sorted,
                                                              unsigned long long* __restrict__ hist, int64_t n,
                                                              int32_t len_t, int32_t subs) {
  extern __shared__ int32_t smem[];
  const int32_t bins = 2 * (len_t + 1);
  const float* thr = thr_sorted;
  int32_t* mine = nullptr;
  if (kSharedHist) {
    float* sthr = reinterpret_cast<float*>(smem);
    for (int32_t i = threadIdx.x; i < len_t; i += blockDim.x) sthr[i] = thr_sorted[i];
    thr = sthr;
    int32_t* sub = smem + len_t;
    for (int32_t i = threadIdx.x; i < bins * subs; i += blockDim.x) sub[i] = 0;
    mine = sub + (static_cast<int32_t>(threadIdx.x >> 5) % subs) * bins;
    __syncthreads();
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; base < n;
       base += stride * kUnroll) {
    float p[kUnroll];
    int32_t t[kUnroll];
    uint8_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + u * stride;
      v[u] = 0;
      if (i < n) {
        p[u] = preds[i];
        t[u] = target[i];
        v[u] = valid[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!v[u]) continue;
      const int k = bucket_of(thr, len_t, p[u]);
      if (kSharedHist) {
        if (t[u] != 1) atomicAdd(&mine[k], 1 - t[u]);
        if (t[u] != 0) atomicAdd(&mine[len_t + 1 + k], t[u]);
      } else {
        if (t[u] != 1) atomicAdd(&hist[k], static_cast<unsigned long long>(static_cast<int64_t>(1 - t[u])));
        if (t[u] != 0) atomicAdd(&hist[len_t + 1 + k], static_cast<unsigned long long>(static_cast<int64_t>(t[u])));
      }
    }
  }
  if (kSharedHist) {
    __syncthreads();
    const int32_t* sub = smem + len_t;
    for (int32_t i = threadIdx.x; i < bins; i += blockDim.x) {
      int64_t total = 0;
      for (int32_t s = 0; s < subs; ++s) total += sub[s * bins + i];
      if (total != 0) atomicAdd(&hist[i], static_cast<unsigned long long>(total));
    }
  }
}

// Exclusive prefix sums of two values a thread across the block (warp
// shuffles, then one warp over the warp totals); `total` receives the
// block's two sums.
__device__ void block_exclusive_scan2(int64_t& x0, int64_t& x1, int64_t (*warp_sums)[32], int64_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int64_t v0 = x0;
  int64_t v1 = x1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t y0 = __shfl_up_sync(0xffffffffu, v0, off);
    const int64_t y1 = __shfl_up_sync(0xffffffffu, v1, off);
    if (lane >= off) {
      v0 += y0;
      v1 += y1;
    }
  }
  if (lane == 31) {
    warp_sums[0][warp] = v0;
    warp_sums[1][warp] = v1;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t w0 = lane < warps ? warp_sums[0][lane] : 0;
    int64_t w1 = lane < warps ? warp_sums[1][lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y0 = __shfl_up_sync(0xffffffffu, w0, off);
      const int64_t y1 = __shfl_up_sync(0xffffffffu, w1, off);
      if (lane >= off) {
        w0 += y0;
        w1 += y1;
      }
    }
    if (lane < warps) {
      warp_sums[0][lane] = w0;
      warp_sums[1][lane] = w1;
    }
    if (lane == warps - 1) {
      total[0] = w0;
      total[1] = w1;
    }
  }
  __syncthreads();
  x0 = v0 - x0 + (warp > 0 ? warp_sums[0][warp - 1] : 0);
  x1 = v1 - x1 + (warp > 0 ? warp_sums[1][warp - 1] : 0);
  __syncthreads();  // warp_sums is reused by the next scan
}

// One thread's strip of kStrip consecutive buckets: both rows' counts and,
// with `order`, the caller's index of each bucket's threshold (0 past the end).
__device__ __forceinline__ void load_strip(const int64_t* __restrict__ hist, const int64_t* __restrict__ order,
                                           int32_t len_t, int32_t first, int64_t* h0, int64_t* h1, int64_t* ord) {
  const int32_t buckets = len_t + 1;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    const int32_t k = first + j;
    h0[j] = k < buckets ? hist[k] : 0;
    h1[j] = k < buckets ? hist[buckets + k] : 0;
    ord[j] = order != nullptr && k < len_t ? order[k] : 0;
  }
}

// Suffix sums, step 1 of 3 (more than one tile of buckets): each block sums
// both rows over its tile of kTile buckets.
__global__ void __launch_bounds__(kFinalizeThreads) binned_tile_sums(const int64_t* __restrict__ hist, int32_t len_t,
                                                                     int64_t* __restrict__ tile_sums) {
  __shared__ int64_t warp_sums[2][32];
  __shared__ int64_t sums[2];
  int64_t h0[kStrip], h1[kStrip], ord[kStrip];
  load_strip(hist, nullptr, len_t, blockIdx.x * kTile + threadIdx.x * kStrip, h0, h1, ord);
  int64_t s0 = 0;
  int64_t s1 = 0;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    s0 += h0[j];
    s1 += h1[j];
  }
  block_exclusive_scan2(s0, s1, warp_sums, sums);
  if (threadIdx.x == 0) {
    tile_sums[2 * blockIdx.x] = sums[0];
    tile_sums[2 * blockIdx.x + 1] = sums[1];
  }
}

// Step 2 of 3, one block: the tile sums become each tile's exclusive prefix
// (in place), and `totals` receives both rows' totals.
__global__ void __launch_bounds__(kFinalizeThreads) binned_tile_carry(int64_t* __restrict__ tile_sums, int32_t tiles,
                                                                      int64_t* __restrict__ totals) {
  __shared__ int64_t warp_sums[2][32];
  __shared__ int64_t sums[2];
  int64_t carry0 = 0;
  int64_t carry1 = 0;
  for (int32_t base = 0; base < tiles; base += blockDim.x) {
    const int32_t i = base + threadIdx.x;
    int64_t x0 = i < tiles ? tile_sums[2 * i] : 0;
    int64_t x1 = i < tiles ? tile_sums[2 * i + 1] : 0;
    block_exclusive_scan2(x0, x1, warp_sums, sums);
    if (i < tiles) {
      tile_sums[2 * i] = carry0 + x0;
      tile_sums[2 * i + 1] = carry1 + x1;
    }
    carry0 += sums[0];
    carry1 += sums[1];
  }
  if (threadIdx.x == 0) {
    totals[0] = carry0;
    totals[1] = carry1;
  }
}

// Step 3 of 3 (the only step for one tile): each block scans its tile of
// kTile buckets, kStrip a thread, adds the tile's carry, and writes the
// (T, 2, 2) counts in the caller's threshold order. With `carries` null the
// grid is one block and its own sums are the row totals.
__global__ void __launch_bounds__(kFinalizeThreads) binned_write_tile(const int64_t* __restrict__ hist,
                                                                      const int64_t* __restrict__ order,
                                                                      int64_t* __restrict__ out, int32_t len_t,
                                                                      const int64_t* __restrict__ carries,
                                                                      const int64_t* __restrict__ totals) {
  __shared__ int64_t warp_sums[2][32];
  __shared__ int64_t sums[2];
  const int32_t first = blockIdx.x * kTile + threadIdx.x * kStrip;
  int64_t h0[kStrip], h1[kStrip], ord[kStrip];
  load_strip(hist, order, len_t, first, h0, h1, ord);
  int64_t run0 = 0;
  int64_t run1 = 0;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    run0 += h0[j];
    run1 += h1[j];
  }
  block_exclusive_scan2(run0, run1, warp_sums, sums);
  const bool single = carries == nullptr;
  const int64_t total0 = single ? sums[0] : totals[0];
  const int64_t total1 = single ? sums[1] : totals[1];
  if (!single) {
    run0 += carries[2 * blockIdx.x];
    run1 += carries[2 * blockIdx.x + 1];
  }
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    // each row's inclusive prefix through bucket k counts the samples
    // predicted negative at sorted threshold k; the rest are predicted positive
    run0 += h0[j];
    run1 += h1[j];
    if (first + j < len_t) {
      const int64_t row = ord[j] * 4;
      out[row] = run0;
      out[row + 1] = total0 - run0;
      out[row + 2] = run1;
      out[row + 3] = total1 - run1;
    }
  }
}

// What every launch on a device needs of the runtime, asked once a device:
// a binned metric makes the same call on every update, and each query costs
// host time that the (host-bound) update pays.
struct DeviceShape {
  bool ready = false;
  int sms = 0;
  size_t smem = 0;  // the dynamic shared memory of the last regime-A launch
  int per_sm = 0;   // its resident blocks an SM
};
constexpr int kMaxDevices = 64;
DeviceShape g_shapes[kMaxDevices];
std::mutex g_shapes_mutex;  // ctypes drops the GIL, so calls may run in parallel

// The current device's SM count and, for a regime-A launch of `smem` bytes of
// dynamic shared memory (0: none), its resident blocks an SM. The first call
// on a device also lifts regime A's shared-memory limit to the card's 227 KB.
cudaError_t launch_shape(size_t smem, int* sms, int* per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_shapes_mutex);
  DeviceShape& shape = g_shapes[device];
  if (!shape.ready) {
    err = cudaDeviceGetAttribute(&shape.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(binned_hist<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSharedBytes));
    if (err != cudaSuccess) return err;
    shape.ready = true;
  }
  if (smem != 0 && smem != shape.smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape.per_sm, binned_hist<true>, kThreads, smem);
    if (err != cudaSuccess) return err;
    shape.smem = smem;
  }
  *sms = shape.sms;
  *per_sm = shape.per_sm;
  return cudaSuccess;
}

}  // namespace

// preds: float32 (n,), target: int32 (n,), valid: bool (n,), thr_sorted:
// float32 (len_t,) ascending, order: int64 (len_t,) with
// thr_sorted[k] = thresholds[order[k]], hist: int64 scratch of
// tm_binned_curve_scratch(len_t) elements (the bucket histogram, zeroed
// here, then the suffix sums' tile sums), out: int64 (len_t, 2, 2); all
// contiguous on the current device. Launches on `stream` and returns the
// first cudaError_t met (0 on success).
extern "C" int64_t tm_binned_curve_scratch(int64_t len_t) {
  const int64_t tiles = (len_t + kTile) / kTile;
  return 2 * (len_t + 1) + (tiles > 1 ? 2 * tiles + 2 : 0);
}

extern "C" int tm_binned_curve(const void* preds, const void* target, const void* valid, const void* thr_sorted,
                               const void* order, void* hist, void* out, int64_t n, int64_t len_t,
                               void* stream) {
  if (len_t <= 0 || len_t > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, 2 * (len_t + 1) * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* p = static_cast<const float*>(preds);
  const auto* t = static_cast<const int32_t*>(target);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* thr = static_cast<const float*>(thr_sorted);
  auto* h = static_cast<unsigned long long*>(hist);
  const int32_t lt = static_cast<int32_t>(len_t);
  if (n > 0) {
    const int64_t thr_bytes = len_t * static_cast<int64_t>(sizeof(float));
    const int64_t sub_bytes = 2 * (len_t + 1) * static_cast<int64_t>(sizeof(int32_t));
    const int64_t fit = (kMaxSharedBytes - thr_bytes) / sub_bytes;
    const int32_t subs = static_cast<int32_t>(fit < kWarps ? fit : kWarps);
    const size_t smem = fit >= 1 ? static_cast<size_t>(thr_bytes + subs * sub_bytes) : 0;
    int sms = 0;
    int per_sm = 0;
    err = launch_shape(smem, &sms, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fit >= 1) {
      int64_t blocks = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sms;
      const int64_t by_n = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
      if (by_n < blocks) blocks = by_n;
      binned_hist<true><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p, t, v, thr, h, n, lt, subs);
    } else {
      int64_t blocks = 2LL * sms;
      const int64_t needed = (n + kGlobalThreads - 1) / kGlobalThreads;
      if (needed < blocks) blocks = needed;
      binned_hist<false><<<static_cast<unsigned>(blocks), kGlobalThreads, 0, s>>>(p, t, v, thr, h, n, lt, 0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* hist64 = static_cast<const int64_t*>(hist);
  const auto* ord = static_cast<const int64_t*>(order);
  auto* out64 = static_cast<int64_t*>(out);
  const int32_t tiles = static_cast<int32_t>((len_t + kTile) / kTile);  // ceil((len_t + 1) / kTile)
  if (tiles == 1) {
    binned_write_tile<<<1, kFinalizeThreads, 0, s>>>(hist64, ord, out64, lt, nullptr, nullptr);
  } else {
    // scratch after the histogram: the tile sums, then the two row totals
    int64_t* tile_sums = static_cast<int64_t*>(hist) + 2 * (len_t + 1);
    int64_t* totals = tile_sums + 2 * static_cast<int64_t>(tiles);
    binned_tile_sums<<<tiles, kFinalizeThreads, 0, s>>>(hist64, lt, tile_sums);
    binned_tile_carry<<<1, kFinalizeThreads, 0, s>>>(tile_sums, tiles, totals);
    binned_write_tile<<<tiles, kFinalizeThreads, 0, s>>>(hist64, ord, out64, lt, tile_sums, totals);
  }
  return static_cast<int>(cudaGetLastError());
}
