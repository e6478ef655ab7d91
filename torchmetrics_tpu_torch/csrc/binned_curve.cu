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
// positive row and 1 - target_n to the negative row (targets taken as int32).
//
// The target is read as the metric holds it: int64, int32 or uint8, with
// either a bool mask or an ignore_index (valid_n = target_n != ignore_index,
// the index cast to the target's type as torch and jnp compare) or neither
// (every sample valid). So the binned metric update hands its batch straight
// to the kernel, with no pass that masks or narrows the target first.
//
//   1. The caller sorts the thresholds (stable; a metric once, when it is
//      built or moved) and passes the sorted values and the permutation.
//   2. Each thread finds a sample's bucket k = #{t : thr_sorted[t] <= pred},
//      0 <= k <= T: a guess table of equal cells over the thresholds' span
//      narrows the search to the thresholds in the score's cell (one or two
//      steps for a grid), where a plain binary search takes log2(T + 1). A
//      NaN score compares false with every threshold, so it lands in bucket
//      0 and counts as predicted negative at every threshold, as in both JAX
//      bodies.
//   3. It adds the sample into one of up to 16 sub-histograms of 2 x (T+1)
//      int32 counts in shared memory (warps take them in turn).
//   4. One launch for T + 1 <= 4096 buckets (the main path has T = 100):
//      each block merges its non-zero counts into an int64 histogram kept
//      per stream (one atomic a bin), then takes a ticket; the last block to
//      take it reads the histogram back, zeroes it and the ticket, runs the
//      suffix sum over the buckets in shared memory and writes the (T, 2, 2)
//      int64 counts in the caller's order. The histogram and the ticket
//      (the wrapper's per-stream buffer, zeroed once when made) are left zero
//      for the next launch on the stream; two streams never share them. No
//      memset, no second launch. (Per-block slots that the last block sums,
//      with no global atomics, took 0.0144 ms against 0.0096 at 1M samples
//      and T = 100 on an H100: the last block reads every slot after all
//      have arrived, where the atomics land while other blocks still count.)
//   5. More buckets: the same merge into the histogram, or, where even one
//      sub-histogram and the thresholds overflow the 227 KB of shared memory
//      (T above about 19,000), a binary search of the thresholds in device
//      memory with atomics straight into it. Three more launches spread the
//      suffix sum over the card (tile sums, one block of carries, tile
//      writes); the tile writes zero the histogram as they read it, so no
//      memset runs here either.
//
// Counts are integers end to end, so they are exact at any N for 0/1
// targets (a block takes at most 2^30 samples, so its int32 counts cannot
// overflow); the Pallas kernel sums in float32 and is exact only up to 2^24
// valid samples a call.
//
// Bound: device-memory bytes. A call must read each score (4 bytes), target
// (8, 4 or 1) and mask (1, if any) once and the T thresholds, and write 32
// bytes a threshold: 12 bytes a sample on the main path (int64 target,
// ignore_index), 3.6 us for 1M samples at 3.35 TB/s. What the design does
// about the bytes: each sample is read once, coalesced, four consecutive
// samples a thread with 16-byte vector loads where the pointers allow; the
// (T, N) compare never exists; the search is a few shared-memory steps. At
// 1M samples the time is mostly fixed latency that one launch still pays:
// the ticket's round trip, the histogram read back and the suffix sum,
// about 5 us with no samples at all. Shared-memory atomic contention when
// most scores fall into a few buckets is spread over the sub-histograms.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;                 // the histogram launch
constexpr int32_t kTile = 4096;                // buckets the one-launch scan owns
constexpr int kFusedStrip = kTile / kThreads;  // of them a thread
constexpr int kStrip = 4;                      // buckets a multi-launch scan thread owns
constexpr int kScanThreads = 256;              // the multi-launch scan's blocks
constexpr int32_t kScanTile = kScanThreads * kStrip;
constexpr int kMaxSubs = 16;
// dynamic shared memory a block may take: the card's 227 KB less room for
// the one-launch kernel's static shared memory (the scan's warp sums, its flag)
constexpr int64_t kMaxSharedBytes = 227 * 1024 - 1024;
constexpr int64_t kSamplesPerBlock = 4 * kThreads;      // at least a group of four a thread
constexpr int64_t kMaxBlockSamples = int64_t{1} << 30;  // keeps a block's int32 counts exact
constexpr int64_t kTicketBytes = 16;                    // the ticket, then the histogram
constexpr int kMaxCells = 2048;                         // guess-table cells

// target dtype codes and validity modes of tm_binned_curve's `form`
enum TargetType { kInt32 = 0, kInt64 = 1, kUint8 = 2 };
enum ValidMode { kAllValid = 0, kMask = 1, kIgnore = 2 };

// what each histogram launch does with its block's counts
enum Regime {
  kFused = 0,        // one launch: merge, ticket, suffix sum, output
  kSharedMerge = 1,  // shared sub-histograms merged into the device histogram
  kGlobal = 2,       // thresholds in device memory, atomics into the device histogram
};

struct Inputs {
  const float* preds;
  const void* target;
  const uint8_t* valid;  // kMask only
  const float* thr_sorted;
  int64_t n;
  int64_t ignore;  // kIgnore only
  int32_t len_t;
  int32_t mode;
  int32_t vector;  // 16-byte (and 4-byte for uint8) loads allowed
  int32_t cells;   // guess-table cells (0: none)
};

// The guess table: `cells` equal cells over [thr[0], thr[T-1]] and, for each,
// hi[c] = #{t : cell(thr[t]) <= c}. cell() is monotone in its argument, so a
// score in cell c has bucket lo + #{t in [lo, hi) : thr[t] <= p} with
// lo = hi[c - 1]: exact whatever the rounding, since thresholds and scores go
// through the same arithmetic. A NaN score goes to cell 0 and compares false,
// so it lands in bucket 0.
struct Table {
  const int32_t* hi;  // null: no table
  float base;
  float scale;
  int32_t cells;
};

__device__ __forceinline__ int cell_of(float x, const Table& tab) {
  return static_cast<int>(fminf(fmaxf((x - tab.base) * tab.scale, 0.0f), static_cast<float>(tab.cells - 1)));
}

__device__ __forceinline__ int upper_bound(const float* thr, int lo, int hi, float p) {
  // the first index in [lo, hi) whose threshold is > p (hi if none; NaN p: lo)
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

// the bucket of score p: #{t : thr[t] <= p}
__device__ __forceinline__ int bucket_of(const float* thr, int len_t, const Table& tab, float p) {
  if (tab.hi == nullptr) return upper_bound(thr, 0, len_t, p);
  const int c = cell_of(p, tab);
  return upper_bound(thr, c > 0 ? tab.hi[c - 1] : 0, tab.hi[c], p);
}

// Builds the block's table in shared memory `hi` (cells entries) from the
// sorted thresholds; no table when the thresholds' span is zero or not
// finite. Every thread gets the same answer.
__device__ Table build_table(const float* thr, int32_t len_t, int32_t cells, int32_t* hi) {
  Table tab{nullptr, 0.0f, 0.0f, cells};
  if (cells <= 0) return tab;
  const float base = thr[0];
  const float span = thr[len_t - 1] - base;
  if (!(span > 0.0f) || !isfinite(span)) return tab;
  tab.base = base;
  tab.scale = static_cast<float>(cells) / span;
  for (int32_t c = threadIdx.x; c < cells; c += blockDim.x) {
    int lo = 0;
    int h = len_t;
    while (lo < h) {
      const int mid = (lo + h) >> 1;
      if (cell_of(thr[mid], tab) <= c) {
        lo = mid + 1;
      } else {
        h = mid;
      }
    }
    hi[c] = lo;
  }
  tab.hi = hi;
  return tab;
}

// Read-only loads of any element type (int64_t is `long`, which the load
// intrinsics may not take: 8-byte values go through `long long`).
template <typename T>
__device__ __forceinline__ T load_ro(const T* p) {
  if constexpr (sizeof(T) == 8) {
    return static_cast<T>(__ldg(reinterpret_cast<const long long*>(p)));
  } else {
    return __ldg(p);
  }
}
// Four consecutive samples from i (a multiple of 4, i + 4 <= n): scores,
// targets as int32 weights, and whether each is valid.
template <typename T>
__device__ __forceinline__ void load4(const Inputs& in, int64_t i, float (&p)[4], int32_t (&w)[4], bool (&ok)[4]) {
  const T* tg = static_cast<const T*>(in.target) + i;
  T t[4];
  if (in.vector) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(in.preds + i));
    p[0] = a.x; p[1] = a.y; p[2] = a.z; p[3] = a.w;
    if constexpr (sizeof(T) == 8) {
      const longlong2 lo = __ldg(reinterpret_cast<const longlong2*>(tg));
      const longlong2 hi = __ldg(reinterpret_cast<const longlong2*>(tg) + 1);
      t[0] = static_cast<T>(lo.x); t[1] = static_cast<T>(lo.y); t[2] = static_cast<T>(hi.x); t[3] = static_cast<T>(hi.y);
    } else if constexpr (sizeof(T) == 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(tg));
      t[0] = static_cast<T>(v.x); t[1] = static_cast<T>(v.y); t[2] = static_cast<T>(v.z); t[3] = static_cast<T>(v.w);
    } else {
      const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(tg));
      t[0] = static_cast<T>(v.x); t[1] = static_cast<T>(v.y); t[2] = static_cast<T>(v.z); t[3] = static_cast<T>(v.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[j] = __ldg(in.preds + i + j);
      t[j] = load_ro(tg + j);
    }
  }
  if (in.mode == kMask) {
    uint8_t m[4];
    if (in.vector) {
      const uchar4 v = __ldg(reinterpret_cast<const uchar4*>(in.valid + i));
      m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = __ldg(in.valid + i + j);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = m[j] != 0;
  } else if (in.mode == kIgnore) {
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = t[j] != static_cast<T>(in.ignore);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = true;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = static_cast<int32_t>(t[j]);
}

template <typename T>
__device__ __forceinline__ void load1(const Inputs& in, int64_t i, float& p, int32_t& w, bool& ok) {
  const T t = load_ro(static_cast<const T*>(in.target) + i);
  p = __ldg(in.preds + i);
  ok = in.mode == kMask ? __ldg(in.valid + i) != 0 : (in.mode == kIgnore ? t != static_cast<T>(in.ignore) : true);
  w = static_cast<int32_t>(t);
}

// One valid sample of weight w (its target) into bucket k: 1 - w negatives, w positives.
template <Regime kRegime>
__device__ __forceinline__ void tally(int32_t* mine, unsigned long long* hist, int32_t buckets, int k, int32_t w) {
  if (kRegime == kGlobal) {
    if (w != 1) atomicAdd(&hist[k], static_cast<unsigned long long>(static_cast<int64_t>(1 - w)));
    if (w != 0) atomicAdd(&hist[buckets + k], static_cast<unsigned long long>(static_cast<int64_t>(w)));
  } else {
    if (w != 1) atomicAdd(&mine[k], 1 - w);
    if (w != 0) atomicAdd(&mine[buckets + k], w);
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

// Writes the (T, 2, 2) counts of one strip of kS buckets starting at
// `first`, whose thresholds sit at ord[j] in the caller's order: each row's
// inclusive prefix through bucket k counts the samples predicted negative at
// sorted threshold k; the rest are predicted positive.
template <int kS>
__device__ __forceinline__ void write_strip(const int64_t (&h0)[kS], const int64_t (&h1)[kS], const int64_t (&ord)[kS],
                                            int64_t* __restrict__ out, int32_t len_t, int32_t first, int64_t run0,
                                            int64_t run1, int64_t total0, int64_t total1) {
#pragma unroll
  for (int j = 0; j < kS; ++j) {
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

// Whether this block is the last of `count` to take `ticket`; the last one
// resets it for the next launch on the stream. Every thread has made its
// writes visible (threadfence) before the block's ticket is taken.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, unsigned count, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned seen = atomicAdd(ticket, 1u);
    *flag = seen == count - 1;
    if (*flag) {
      *ticket = 0u;  // no other block of this launch takes it again
      __threadfence();
    }
  }
  __syncthreads();
  return *flag;
}

__host__ __device__ constexpr int64_t align16(int64_t bytes) { return (bytes + 15) & ~int64_t{15}; }

// The histogram launch. kFused: sorted thresholds, the guess table and
// `subs` sub-histograms in shared memory; each block's counts merged into
// the stream's histogram `hist`; the last block's suffix sum and output.
// kSharedMerge: the same, merged into `hist` for the multi-launch scan.
// kGlobal: the thresholds searched in device memory and counts added
// straight into `hist`.
template <typename T, Regime kRegime>
__global__ void __launch_bounds__(kThreads) binned_hist(const Inputs in, unsigned long long* __restrict__ hist,
                                                        unsigned* __restrict__ ticket,
                                                        const int64_t* __restrict__ order,
                                                        int64_t* __restrict__ out, int32_t subs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int32_t len_t = in.len_t;
  const int32_t buckets = len_t + 1;
  const int32_t bins = 2 * buckets;
  const float* thr = in.thr_sorted;
  unsigned char* next = smem_raw;
  if (kRegime != kGlobal) {
    float* sthr = reinterpret_cast<float*>(next);
    for (int32_t i = threadIdx.x; i < len_t; i += blockDim.x) sthr[i] = thr[i];
    thr = sthr;
    next += align16(static_cast<int64_t>(len_t) * 4);
    __syncthreads();
  }
  int32_t* table = reinterpret_cast<int32_t*>(next);
  next += align16(static_cast<int64_t>(in.cells) * 4);
  int32_t* sub = reinterpret_cast<int32_t*>(next);
  int32_t* mine = nullptr;
  if (kRegime != kGlobal) {
    for (int32_t i = threadIdx.x; i < bins * subs; i += blockDim.x) sub[i] = 0;
    mine = sub + (static_cast<int32_t>(threadIdx.x >> 5) % subs) * bins;
  }
  const Table tab = build_table(thr, len_t, in.cells, table);
  __syncthreads();
  const int64_t n = in.n;
  const int64_t quads = n >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < quads; q += stride) {
    float p[4];
    int32_t w[4];
    bool ok[4];
    load4<T>(in, q << 2, p, w, ok);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok[j]) tally<kRegime>(mine, hist, buckets, bucket_of(thr, len_t, tab, p[j]), w[j]);
    }
  }
  // the last n % 4 samples
  const int64_t tail = (quads << 2) + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tail < n) {
    float p;
    int32_t w;
    bool ok;
    load1<T>(in, tail, p, w, ok);
    if (ok) tally<kRegime>(mine, hist, buckets, bucket_of(thr, len_t, tab, p), w);
  }
  if (kRegime == kGlobal) return;
  __syncthreads();
  for (int32_t i = threadIdx.x; i < bins; i += blockDim.x) {
    int32_t total = 0;
    for (int32_t s = 0; s < subs; ++s) total += sub[s * bins + i];
    if (total != 0) atomicAdd(&hist[i], static_cast<unsigned long long>(static_cast<int64_t>(total)));
  }
  if (kRegime == kSharedMerge) return;

  // kFused: the last block to arrive reads the histogram back (and zeroes
  // it), with its strip's places in the caller's order, and writes the counts
  __shared__ bool last;
  __shared__ int64_t warp_sums[2][32];
  __shared__ int64_t sums[2];
  if (!last_to_arrive(ticket, gridDim.x, &last)) return;
  const int32_t firstk = threadIdx.x * kFusedStrip;
  int64_t ord[kFusedStrip];
#pragma unroll
  for (int j = 0; j < kFusedStrip; ++j) ord[j] = firstk + j < len_t ? order[firstk + j] : 0;
  int64_t* totals = reinterpret_cast<int64_t*>(smem_raw);  // the thresholds and sub-histograms are done
  for (int32_t i = threadIdx.x; i < bins; i += blockDim.x) {
    totals[i] = static_cast<int64_t>(__ldcg(hist + i));
    hist[i] = 0ull;
  }
  __syncthreads();
  // suffix sums over the T + 1 <= kTile buckets, kFusedStrip a thread
  int64_t h0[kFusedStrip], h1[kFusedStrip];
  int64_t run0 = 0;
  int64_t run1 = 0;
#pragma unroll
  for (int j = 0; j < kFusedStrip; ++j) {
    const int32_t k = firstk + j;
    h0[j] = k < buckets ? totals[k] : 0;
    h1[j] = k < buckets ? totals[buckets + k] : 0;
    run0 += h0[j];
    run1 += h1[j];
  }
  block_exclusive_scan2(run0, run1, warp_sums, sums);
  write_strip(h0, h1, ord, out, len_t, firstk, run0, run1, sums[0], sums[1]);
}

// One thread's strip of kStrip consecutive buckets of the device histogram
// (0 past the end). With `clear` it zeroes what it read: the tile writes are
// the histogram's last readers, and the next call finds it zero.
__device__ __forceinline__ void load_strip(int64_t* __restrict__ hist, int32_t len_t, int32_t first, int64_t* h0,
                                           int64_t* h1, bool clear) {
  const int32_t buckets = len_t + 1;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    const int32_t k = first + j;
    h0[j] = k < buckets ? hist[k] : 0;
    h1[j] = k < buckets ? hist[buckets + k] : 0;
    if (clear && k < buckets) {
      hist[k] = 0;
      hist[buckets + k] = 0;
    }
  }
}

// Suffix sums, step 1 of 3 (more than one tile of buckets): each block sums
// both rows over its tile of kScanTile buckets.
__global__ void __launch_bounds__(kScanThreads) binned_tile_sums(int64_t* __restrict__ hist, int32_t len_t,
                                                                 int64_t* __restrict__ tile_sums) {
  __shared__ int64_t warp_sums[2][32];
  __shared__ int64_t sums[2];
  int64_t h0[kStrip], h1[kStrip];
  load_strip(hist, len_t, blockIdx.x * kScanTile + threadIdx.x * kStrip, h0, h1, false);
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
__global__ void __launch_bounds__(kThreads) binned_tile_carry(int64_t* __restrict__ tile_sums, int32_t tiles,
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

// Step 3 of 3: each block scans its tile of kScanTile buckets, kStrip a
// thread, adds the tile's carry, writes the (T, 2, 2) counts in the caller's
// threshold order and zeroes the histogram it read.
__global__ void __launch_bounds__(kScanThreads) binned_write_tile(int64_t* __restrict__ hist,
                                                                  const int64_t* __restrict__ order,
                                                                  int64_t* __restrict__ out, int32_t len_t,
                                                                  const int64_t* __restrict__ carries,
                                                                  const int64_t* __restrict__ totals) {
  __shared__ int64_t warp_sums[2][32];
  __shared__ int64_t sums[2];
  const int32_t first = blockIdx.x * kScanTile + threadIdx.x * kStrip;
  int64_t h0[kStrip], h1[kStrip];
  load_strip(hist, len_t, first, h0, h1, true);
  int64_t run0 = 0;
  int64_t run1 = 0;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    run0 += h0[j];
    run1 += h1[j];
  }
  int64_t ord[kStrip];
#pragma unroll
  for (int j = 0; j < kStrip; ++j) ord[j] = first + j < len_t ? order[first + j] : 0;
  block_exclusive_scan2(run0, run1, warp_sums, sums);
  run0 += carries[2 * blockIdx.x];
  run1 += carries[2 * blockIdx.x + 1];
  write_strip(h0, h1, ord, out, len_t, first, run0, run1, totals[0], totals[1]);
}

// A kernel instantiation and, once a device, the runtime's answers it needs:
// the shared-memory limit lifted to the card's 227 KB, and its resident
// blocks an SM for the last dynamic shared-memory size it was launched with.
struct KernelShape {
  size_t smem = 0;
  int per_sm = 0;
  bool lifted = false;
};
constexpr int kKernels = 9;  // 3 target types x 3 regimes
KernelShape g_shapes[tm_launch::kMaxDevices][kKernels];
std::mutex g_shapes_mutex;  // ctypes drops the GIL, so calls may run in parallel

template <typename T, Regime kRegime>
cudaError_t resident_blocks(int device, int slot, size_t smem, int* per_sm) {
  const auto kernel = binned_hist<T, kRegime>;
  std::lock_guard<std::mutex> lock(g_shapes_mutex);
  KernelShape& shape = g_shapes[device][slot];
  cudaError_t err = cudaSuccess;
  if (!shape.lifted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSharedBytes));
    if (err != cudaSuccess) return err;
    shape.lifted = true;
  }
  if (shape.per_sm == 0 || shape.smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shape.per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    shape.smem = smem;
  }
  *per_sm = shape.per_sm < 1 ? 1 : shape.per_sm;
  return cudaSuccess;
}

// The launch plan of one call: regime, grid, shared memory and the scratch
// it needs. The wrapper keeps, per stream, a `zeroed` buffer (tickets and
// the device histogram, zero between calls) and a `scratch` buffer; a plan
// that needs more of either than the wrapper holds makes the entry return
// kNeedScratch with nothing launched.
struct Plan {
  Regime regime;
  int64_t blocks;
  size_t smem;
  int32_t subs;
  int32_t tiles;  // the multi-launch scan's
  int32_t cells;
  int64_t zeroed_bytes;
  int64_t scratch_bytes;
};

constexpr int kNeedScratch = -1;

cudaError_t make_plan(int device, int target_type, int64_t n, int64_t len_t, Plan* plan) {
  const int64_t buckets = len_t + 1;
  const int64_t bins = 2 * buckets;
  // cells: twice the thresholds, a power of two up to kMaxCells
  int32_t cells = 1;
  while (cells < 2 * len_t && cells < kMaxCells) cells <<= 1;
  int64_t table_bytes = align16(cells * 4);
  const int64_t thr_bytes = align16(len_t * 4);
  const int64_t sub_bytes = bins * static_cast<int64_t>(sizeof(int32_t));
  // as many sub-histograms as keep two blocks an SM, at least one
  int64_t subs = (kMaxSharedBytes / 2 - thr_bytes - table_bytes) / sub_bytes;
  if (subs < 1) subs = (kMaxSharedBytes - thr_bytes - table_bytes) / sub_bytes;
  if (subs > kMaxSubs) subs = kMaxSubs;
  if (subs < 0) subs = 0;
  plan->subs = static_cast<int32_t>(subs);
  plan->regime = buckets <= kTile ? kFused : (subs >= 1 ? kSharedMerge : kGlobal);
  if (plan->regime == kGlobal) {  // the searches run in device memory, whose latency a table does not hide
    cells = 0;
    table_bytes = 0;
  }
  plan->cells = cells;
  plan->tiles = static_cast<int32_t>((buckets + kScanTile - 1) / kScanTile);
  plan->smem = static_cast<size_t>(plan->regime == kGlobal ? table_bytes : thr_bytes + table_bytes + subs * sub_bytes);
  if (plan->regime == kFused && plan->smem < static_cast<size_t>(bins * sizeof(int64_t))) {
    plan->smem = static_cast<size_t>(bins * sizeof(int64_t));  // the last block's int64 totals
  }
  int sms = 0;
  cudaError_t err = tm_launch::sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  int per_sm = 1;
  const int slot = target_type * 3 + plan->regime;
  switch (slot) {
    case kInt32 * 3 + kFused: err = resident_blocks<int32_t, kFused>(device, slot, plan->smem, &per_sm); break;
    case kInt32 * 3 + kSharedMerge: err = resident_blocks<int32_t, kSharedMerge>(device, slot, plan->smem, &per_sm); break;
    case kInt32 * 3 + kGlobal: err = resident_blocks<int32_t, kGlobal>(device, slot, plan->smem, &per_sm); break;
    case kInt64 * 3 + kFused: err = resident_blocks<int64_t, kFused>(device, slot, plan->smem, &per_sm); break;
    case kInt64 * 3 + kSharedMerge: err = resident_blocks<int64_t, kSharedMerge>(device, slot, plan->smem, &per_sm); break;
    case kInt64 * 3 + kGlobal: err = resident_blocks<int64_t, kGlobal>(device, slot, plan->smem, &per_sm); break;
    case kUint8 * 3 + kFused: err = resident_blocks<uint8_t, kFused>(device, slot, plan->smem, &per_sm); break;
    case kUint8 * 3 + kSharedMerge: err = resident_blocks<uint8_t, kSharedMerge>(device, slot, plan->smem, &per_sm); break;
    default: err = resident_blocks<uint8_t, kGlobal>(device, slot, plan->smem, &per_sm); break;
  }
  if (err != cudaSuccess) return err;
  int64_t blocks = static_cast<int64_t>(per_sm) * sms;
  const int64_t by_n = (n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (by_n < blocks) blocks = by_n;
  const int64_t floor = (n + kMaxBlockSamples - 1) / kMaxBlockSamples;
  if (blocks < floor) blocks = floor;
  if (blocks < 1) blocks = 1;
  plan->blocks = blocks;
  if (plan->regime == kFused) {
    plan->zeroed_bytes = kTicketBytes + bins * static_cast<int64_t>(sizeof(int64_t));
    plan->scratch_bytes = 0;
  } else {
    plan->zeroed_bytes = bins * static_cast<int64_t>(sizeof(int64_t));
    plan->scratch_bytes = (2 * static_cast<int64_t>(plan->tiles) + 2) * static_cast<int64_t>(sizeof(int64_t));
  }
  return cudaSuccess;
}

template <typename T>
void launch_hist(const Plan& plan, const Inputs& in, unsigned long long* hist, unsigned* ticket,
                 const int64_t* order, int64_t* out, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(plan.blocks);
  switch (plan.regime) {
    case kFused:
      binned_hist<T, kFused><<<grid, kThreads, plan.smem, s>>>(in, hist, ticket, order, out, plan.subs);
      break;
    case kSharedMerge:
      binned_hist<T, kSharedMerge><<<grid, kThreads, plan.smem, s>>>(in, hist, ticket, order, out, plan.subs);
      break;
    default: binned_hist<T, kGlobal><<<grid, kThreads, plan.smem, s>>>(in, hist, ticket, order, out, 0); break;
  }
}

}  // namespace

// The zeroed and scratch bytes a call of n samples and len_t thresholds
// needs on `device` (sizes[0], sizes[1]); returns the first cudaError_t met.
extern "C" int tm_binned_curve_scratch(int device, int target_type, int64_t n, int64_t len_t, int64_t* sizes) {
  if (len_t <= 0 || len_t > (1 << 30) || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  tm_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Plan plan;
  const cudaError_t err = make_plan(device, target_type, n, len_t, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  sizes[0] = plan.zeroed_bytes;
  sizes[1] = plan.scratch_bytes;
  return 0;
}

// preds: float32 (n,); target: (n,) of `form & 3` (0 int32, 1 int64, 2
// uint8); `form >> 2` is the validity mode (0 every sample valid, 1 the bool
// mask `valid` (n,), 2 target != ignore_index); thr_sorted: float32 (len_t,)
// ascending; order: int64 (len_t,) with thr_sorted[k] = thresholds[order[k]];
// zeroed / scratch: the calling stream's buffers of the given capacities
// (zeroed must be zero, and is left zero); out: int64 (len_t, 2, 2). All
// contiguous on `device`, which is made current for the call and restored.
// Launches on `stream`; returns 0, the first cudaError_t met, or
// kNeedScratch (-1) with nothing launched when a buffer is too small
// (tm_binned_curve_scratch gives the sizes).
extern "C" int tm_binned_curve(int device, const void* preds, const void* target, const void* valid, int form,
                               int64_t ignore_index, const void* thr_sorted, const void* order, void* zeroed,
                               int64_t zeroed_capacity, void* scratch, int64_t scratch_capacity, void* out, int64_t n,
                               int64_t len_t, void* stream) {
  const int target_type = form & 3;
  const int mode = form >> 2;
  if (len_t <= 0 || len_t > (1 << 30) || n < 0 || target_type > kUint8 || mode > kIgnore ||
      (mode == kMask && valid == nullptr && n > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tm_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  Plan plan;
  cudaError_t err = make_plan(device, target_type, n, len_t, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.zeroed_bytes > zeroed_capacity || plan.scratch_bytes > scratch_capacity) return kNeedScratch;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tsize = target_type == kInt64 ? 8 : (target_type == kInt32 ? 4 : 1);
  const bool vector = reinterpret_cast<uintptr_t>(preds) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(target) % (4 * tsize < 16 ? 4 * tsize : 16) == 0 &&
                      (mode != kMask || reinterpret_cast<uintptr_t>(valid) % 4 == 0);
  const Inputs in{static_cast<const float*>(preds), target, static_cast<const uint8_t*>(valid),
                  static_cast<const float*>(thr_sorted), n, ignore_index, static_cast<int32_t>(len_t), mode,
                  vector ? 1 : 0, plan.cells};
  // one launch: the ticket, then the histogram; more: the histogram alone
  auto* zero_bytes = static_cast<unsigned char*>(zeroed);
  auto* ticket = static_cast<unsigned*>(zeroed);
  auto* hist = reinterpret_cast<unsigned long long*>(plan.regime == kFused ? zero_bytes + kTicketBytes : zero_bytes);
  const auto* ord = static_cast<const int64_t*>(order);
  auto* out64 = static_cast<int64_t*>(out);
  if (plan.regime == kFused || n > 0) {
    switch (target_type) {
      case kInt32: launch_hist<int32_t>(plan, in, hist, ticket, ord, out64, s); break;
      case kInt64: launch_hist<int64_t>(plan, in, hist, ticket, ord, out64, s); break;
      default: launch_hist<uint8_t>(plan, in, hist, ticket, ord, out64, s); break;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (plan.regime == kFused) return 0;
  // scratch: the tile sums, then the two row totals
  auto* hist64 = static_cast<int64_t*>(zeroed);
  auto* tile_sums = static_cast<int64_t*>(scratch);
  int64_t* totals = tile_sums + 2 * static_cast<int64_t>(plan.tiles);
  const int32_t lt = static_cast<int32_t>(len_t);
  binned_tile_sums<<<plan.tiles, kScanThreads, 0, s>>>(hist64, lt, tile_sums);
  binned_tile_carry<<<1, kThreads, 0, s>>>(tile_sums, plan.tiles, totals);
  binned_write_tile<<<plan.tiles, kScanThreads, 0, s>>>(hist64, ord, out64, lt, tile_sums, totals);
  return static_cast<int>(cudaGetLastError());
}
