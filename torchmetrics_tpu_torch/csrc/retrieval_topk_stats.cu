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
// L = 1,000) that is 27.9 MB, 0.0083 ms at 3.35 TB/s; at MovieLens-20M's
// 138,493 users x 100 candidates 58 MB, 0.0166 ms.
//
// Design: a group of G lanes per row, so a warp sums 32 / G rows at once.
// Each lane keeps up to kUnroll = 4 16-byte loads in flight, so a group reads
// 16 * G values in one round. G is the fewest lanes that read the row in one
// round (4 lanes up to 64 values, 8 up to 128, 16 up to 256, 32 up to 512),
// and 16 above 512, where every group needs more than one round: there a
// warp has the same loads in flight whatever G, and 16 lanes reduce two rows
// with the shuffles 32 lanes spend on one (MS MARCO's 1,000 values: 6.66 us
// against 7.13 on an H100 80GB HBM3 at 700 W, tools/torch_kernel_sweep.py;
// 41 against 46 at 4,096). A 100-wide row is
// 25 float4s: a warp a row left 7 of 32 lanes idle on them and reduced with
// 20 shuffles; 8 lanes read 3 or 4 each in one round and reduce four rows
// with 12. Lanes read the row coalesced (16-byte vector loads where the row
// length and base allow it), keep the four partial sums in registers, reduce
// them with shuffles inside the group, and the group's first lane writes the
// row's four floats as one 16-byte store. Warps stride over row groups with
// a trip count the same for every lane, so every shuffle has the whole warp.
// No shared memory, no atomics: each row's sum runs in one fixed order. With
// 0/1 targets every partial sum is an integer below 2^24, so the result
// equals the plain body bit for bit; other values are summed in another
// order than the plain body's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kBlocksPerSM = 16;
constexpr int kUnroll = 4;  // 16-byte loads in flight a lane

struct Sums {
  float hits, total, inv_hits, inv_total;
};

__device__ __forceinline__ void add(Sums& s, float t, int pos, int k, int c) {
  const float in_k = pos < k ? 1.0f : 0.0f;
  const float inv = pos < c ? 1.0f - t : 0.0f;
  s.hits += t * in_k;
  s.total += t;
  s.inv_hits += inv * in_k;
  s.inv_total += inv;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = G / 2; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset, G);
  return v;
}

template <int G, bool kVec4>
__global__ void __launch_bounds__(kThreads) topk_stats(const float* __restrict__ t,
                                                       const int32_t* __restrict__ counts,
                                                       float4* __restrict__ out, int64_t q,
                                                       int64_t len, int64_t top_k) {
  constexpr int kRows = 32 / G;  // rows a warp sums at once
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t base = warp * kRows; base < q; base += warps * kRows) {
    const int64_t row = base + lane / G;
    Sums s{0.0f, 0.0f, 0.0f, 0.0f};
    if (row < q) {
      const int c = counts[row];
      const int k = top_k < 0 ? c : static_cast<int>(top_k < c ? top_k : c);
      const float* r = t + row * len;
      if (kVec4) {
        // up to four 16-byte loads in flight a lane: a 100-wide row over 8
        // lanes is one round trip to memory, MS MARCO's 1,000 over 16 four
        const float4* r4 = reinterpret_cast<const float4*>(r);
        const int n4 = static_cast<int>(len >> 2);
        for (int i = g; i < n4; i += kUnroll * G) {
          float4 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            v[u] = i + u * G < n4 ? r4[i + u * G] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (i + u * G < n4) {
              const int p0 = (i + u * G) << 2;
              add(s, v[u].x, p0, k, c);
              add(s, v[u].y, p0 + 1, k, c);
              add(s, v[u].z, p0 + 2, k, c);
              add(s, v[u].w, p0 + 3, k, c);
            }
          }
        }
      } else {
        for (int pos = g; pos < len; pos += G) add(s, r[pos], pos, k, c);
      }
    }
    s.hits = group_sum<G>(s.hits);
    s.total = group_sum<G>(s.total);
    s.inv_hits = group_sum<G>(s.inv_hits);
    s.inv_total = group_sum<G>(s.inv_total);
    if (row < q && g == 0) out[row] = make_float4(s.hits, s.total, s.inv_hits, s.inv_total);
  }
}

// The lanes that sum a row of `len` values (see the design note above).
int lanes_for(int64_t len) {
  if (len <= 64) return 4;
  if (len <= 128) return 8;
  if (len <= 256) return 16;
  return len <= 512 ? 32 : 16;
}

template <int G>
void launch(bool vec4, unsigned blocks, cudaStream_t s, const float* t, const int32_t* counts, float4* out,
            int64_t q, int64_t len, int64_t top_k) {
  if (vec4) {
    topk_stats<G, true><<<blocks, kThreads, 0, s>>>(t, counts, out, q, len, top_k);
  } else {
    topk_stats<G, false><<<blocks, kThreads, 0, s>>>(t, counts, out, q, len, top_k);
  }
}

}  // namespace

// t: float32 (q, len) row-major, counts: int32 (q,), out: float32 (q, 4), all
// contiguous on `device`, which is made current for the call and restored;
// top_k < 0 takes each whole row. Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int tm_retrieval_topk_stats(int device, const void* t, const void* counts, void* out, int64_t q,
                                       int64_t len, int64_t top_k, void* stream) {
  if (q <= 0) return 0;
  if (len < 0 || len > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);  // positions are int
  const int lanes = lanes_for(len);
  tm_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  int sms = 0;
  const cudaError_t err = tm_launch::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_per_block = static_cast<int64_t>(kWarps) * (32 / lanes);
  const int64_t needed = (q + rows_per_block - 1) / rows_per_block;
  const int64_t cap = kBlocksPerSM * sms;
  const unsigned blocks = static_cast<unsigned>(needed < cap ? needed : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tf = static_cast<const float*>(t);
  const auto* ci = static_cast<const int32_t*>(counts);
  auto* o = static_cast<float4*>(out);
  const bool vec4 = len % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  switch (lanes) {
    case 4: launch<4>(vec4, blocks, s, tf, ci, o, q, len, top_k); break;
    case 8: launch<8>(vec4, blocks, s, tf, ci, o, q, len, top_k); break;
    case 16: launch<16>(vec4, blocks, s, tf, ci, o, q, len, top_k); break;
    default: launch<32>(vec4, blocks, s, tf, ci, o, q, len, top_k); break;
  }
  return static_cast<int>(cudaGetLastError());
}
