// Fused top-k retrieval statistics for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/topk_kernel.py:_topk_stats_pallas
// (body _topk_stats_kernel), which reduces an (8, Lp) tile of the ranked
// target grid per grid step. It computes, per query row q of the (Q, L) grid
// of targets in retrieval order, with c = counts[q] and k = min(top_k, c)
// (k = c for top_k < 0, the whole row):
//
//   out[q] = [ sum_{pos<k} t,  sum_pos t,
//              sum_{pos<k} (1 - t)[pos<c],  sum_pos (1 - t)[pos<c] ]
//
// with the plain body's arithmetic: the top-k mask multiplies (t * 1.0 or
// t * 0.0) and the count mask selects, so a non-finite target propagates as
// it does there. Precision@k, recall@k, fall-out@k and hit-rate@k all read
// these four sums.
//
// Bound: device-memory bytes. A call must read the Q*L*4 bytes of the grid
// and Q*4 bytes of counts, and write Q*16 bytes; four masked adds a value are
// far below the card's arithmetic rate. At MS MARCO dev (Q = 6,980,
// L = 1,000) that is 27.9 MB, 0.0083 ms at 3.35 TB/s.
//
// Design: one warp per row, warps striding over rows. Lanes read the row
// coalesced (16-byte vector loads where the row length and base allow it,
// four values a lane, two loads in flight), keep the four partial sums in
// registers, reduce them with warp shuffles, and lane 0 writes the row's four
// floats as one 16-byte store. No shared memory, no atomics: each row's sum
// runs in one fixed order. With 0/1 targets every partial sum is an integer
// below 2^24, so the result equals the plain body bit for bit; other values
// are summed in another order than the plain body's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kBlocksPerSM = 16;

struct Sums {
  float hits, total, inv_hits, inv_total;
};

__device__ __forceinline__ void add(Sums& s, float t, int64_t pos, int64_t k, int64_t c) {
  const float in_k = pos < k ? 1.0f : 0.0f;
  const float inv = pos < c ? 1.0f - t : 0.0f;
  s.hits += t * in_k;
  s.total += t;
  s.inv_hits += inv * in_k;
  s.inv_total += inv;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) topk_stats(const float* __restrict__ t,
                                                       const int32_t* __restrict__ counts,
                                                       float4* __restrict__ out, int64_t q,
                                                       int64_t len, int64_t top_k) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = warp; row < q; row += warps) {
    const int64_t c = counts[row];
    const int64_t k = top_k < 0 ? c : (top_k < c ? top_k : c);
    const float* r = t + row * len;
    Sums s{0.0f, 0.0f, 0.0f, 0.0f};
    if (kVec4) {
      const float4* r4 = reinterpret_cast<const float4*>(r);
      const int64_t n4 = len >> 2;
      int64_t i = lane;
      for (; i + 32 < n4; i += 64) {  // two 16-byte loads in flight a lane
        const float4 a = r4[i];
        const float4 b = r4[i + 32];
        const int64_t pa = i << 2, pb = (i + 32) << 2;
        add(s, a.x, pa, k, c); add(s, a.y, pa + 1, k, c); add(s, a.z, pa + 2, k, c); add(s, a.w, pa + 3, k, c);
        add(s, b.x, pb, k, c); add(s, b.y, pb + 1, k, c); add(s, b.z, pb + 2, k, c); add(s, b.w, pb + 3, k, c);
      }
      for (; i < n4; i += 32) {
        const float4 a = r4[i];
        const int64_t pa = i << 2;
        add(s, a.x, pa, k, c); add(s, a.y, pa + 1, k, c); add(s, a.z, pa + 2, k, c); add(s, a.w, pa + 3, k, c);
      }
    } else {
      for (int64_t pos = lane; pos < len; pos += 32) add(s, r[pos], pos, k, c);
    }
    s.hits = warp_sum(s.hits);
    s.total = warp_sum(s.total);
    s.inv_hits = warp_sum(s.inv_hits);
    s.inv_total = warp_sum(s.inv_total);
    if (lane == 0) out[row] = make_float4(s.hits, s.total, s.inv_hits, s.inv_total);
  }
}

}  // namespace

// t: float32 (q, len) row-major, counts: int32 (q,), out: float32 (q, 4), all
// contiguous on the current device; top_k < 0 takes each whole row. Launches
// on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int tm_retrieval_topk_stats(const void* t, const void* counts, void* out, int64_t q, int64_t len,
                                       int64_t top_k, void* stream) {
  if (q <= 0) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t needed = (q + kWarps - 1) / kWarps;
  const int64_t cap = kBlocksPerSM * sms;
  const unsigned blocks = static_cast<unsigned>(needed < cap ? needed : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tf = static_cast<const float*>(t);
  const auto* ci = static_cast<const int32_t*>(counts);
  auto* o = static_cast<float4*>(out);
  const bool vec4 = len % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  if (vec4) {
    topk_stats<true><<<blocks, kThreads, 0, s>>>(tf, ci, o, q, len, top_k);
  } else {
    topk_stats<false><<<blocks, kThreads, 0, s>>>(tf, ci, o, q, len, top_k);
  }
  return static_cast<int>(cudaGetLastError());
}
