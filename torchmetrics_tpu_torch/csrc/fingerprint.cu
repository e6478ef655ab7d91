// State fingerprint fold for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces no Pallas kernel: the JAX package folds a state tree with XLA, in
// one jitted dispatch (torchmetrics_tpu/integrity.py:_device_leaf_fp, :112,
// and _device_shard_fp, :122). PyTorch has no XOR reduction and no uint32 sum
// on the CPU, and a plain fold is a tree of log2(N) halving passes with N/2
// words of temporaries a leaf: at GLDv2-clean's class-sharded confusion state
// (6.6e9 words, 26.45 GB) gigabytes of temporaries and many passes. This
// kernel folds every segment of a state tree in one launch and one read.
//
// For each segment s of a table (a whole leaf, or one row of a leaf's leading
// axis) it computes
//
//   out[s] = ( XOR_i u_i ,  SUM_i u_i mod 2^32 )
//
// over the segment's 32-bit words u_i: a 4-byte element is one word, an
// 8-byte element two; 1- and 2-byte elements are zero-extended through their
// unsigned view (a bool is 0 or 1). An empty segment gives (0, 0). Both folds
// are exact and commutative, so the result does not depend on the schedule.
//
// Bound: device-memory bytes. A call reads every segment once and writes 8
// bytes a segment; one XOR and one add a word are far below the card's integer
// rate. GLDv2's stack: 26.45 GB, 7.90 ms at 3.35 TB/s.
//
// The segment table (pointer, units, width) of up to 128 segments rides in the
// launch's parameters; a larger one is copied to the card by the caller.
//
// Design: a 2-D grid, y over segments (strided past the grid's 65,535), x over
// one segment's blocks. A thread strides over 16-byte loads (four in flight)
// of the 16-byte aligned body of a word segment; its head and tail words (at
// most three each) are scalar loads. Byte and halfword segments are read a
// unit at a time (no state of the main path holds them in bulk). Each thread
// keeps its XOR and wrapping sum in registers; a warp-shuffle reduction, the
// block's warps through shared memory, then one atomicXor and one atomicAdd on
// the segment's two output words. The entry zeroes the outputs with
// cudaMemsetAsync on the same stream first. Indices are int64: a segment may
// hold more than 2^32 words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kBlocksPerSM = 8;
constexpr int kUnroll = 4;          // 16-byte loads in flight a thread
constexpr int64_t kMaxGridY = 65535;
constexpr int kInlineSegments = 128;  // a table this small rides in the launch's parameters

// The segment table passed by value (3 KB of the 4 KB of kernel parameters):
// a capture of a metric's state then needs no host buffer, no copy and no
// allocation before its launch.
struct InlineTable {
  int64_t v[3 * kInlineSegments];
};

__device__ __forceinline__ void add_word(uint32_t& x, uint32_t& s, uint32_t w) {
  x ^= w;
  s += w;
}

__device__ __forceinline__ void add_vec(uint32_t& x, uint32_t& s, uint4 v) {
  x ^= v.x ^ v.y ^ v.z ^ v.w;
  s += v.x + v.y + v.z + v.w;
}

template <typename T>
__device__ __forceinline__ void fold_units(const T* __restrict__ p, int64_t n, int64_t first, int64_t stride,
                                           uint32_t& x, uint32_t& s) {
  for (int64_t i = first; i < n; i += stride) add_word(x, s, static_cast<uint32_t>(p[i]));
}

__device__ __forceinline__ void fold_words(const uint32_t* __restrict__ p, int64_t n, int64_t first, int64_t stride,
                                           uint32_t& x, uint32_t& s) {
  int64_t head = static_cast<int64_t>(((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  if (first < head) add_word(x, s, p[first]);
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const int64_t nv = (n - head) >> 2;
  int64_t i = first;
  for (; i + (kUnroll - 1) * stride < nv; i += kUnroll * stride) {
    uint4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = __ldg(v + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_vec(x, s, a[u]);
  }
  for (; i < nv; i += stride) add_vec(x, s, __ldg(v + i));
  const int64_t tail = head + (nv << 2);
  if (first < n - tail) add_word(x, s, p[tail + first]);
}

// table: int64 triples (pointer, units, width in bytes: 1, 2 or 4) a segment,
// in device memory, or in `inline_table` when `device_table` is null.
__global__ void __launch_bounds__(kThreads) fingerprint_fold(const int64_t* __restrict__ device_table,
                                                             const __grid_constant__ InlineTable inline_table,
                                                             int64_t segments, uint32_t* __restrict__ out) {
  const int64_t* table = device_table != nullptr ? device_table : inline_table.v;
  __shared__ uint32_t sx[kWarps];
  __shared__ uint32_t ss[kWarps];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int64_t seg = blockIdx.y; seg < segments; seg += gridDim.y) {
    const int64_t n = table[3 * seg + 1];
    if (static_cast<int64_t>(blockIdx.x) * kThreads >= n) continue;  // the same for the whole block
    const void* ptr = reinterpret_cast<const void*>(table[3 * seg]);
    const int64_t width = table[3 * seg + 2];
    uint32_t x = 0u, s = 0u;
    if (width == 4) {
      fold_words(static_cast<const uint32_t*>(ptr), n, first, stride, x, s);
    } else if (width == 2) {
      fold_units(static_cast<const uint16_t*>(ptr), n, first, stride, x, s);
    } else {
      fold_units(static_cast<const uint8_t*>(ptr), n, first, stride, x, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x ^= __shfl_xor_sync(0xffffffffu, x, off);
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      sx[warp] = x;
      ss[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      x = lane < kWarps ? sx[lane] : 0u;
      s = lane < kWarps ? ss[lane] : 0u;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        x ^= __shfl_xor_sync(0xffffffffu, x, off);
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) {
        if (x) atomicXor(out + 2 * seg, x);
        if (s) atomicAdd(out + 2 * seg + 1, s);
      }
    }
    __syncthreads();  // the shared words are written again for the next segment
  }
}

}  // namespace

// host_table: the table in host memory, used for up to kInlineSegments
// segments (copied into the launch's parameters); device_table: the same
// table in device memory, needed past that (either may be null otherwise).
extern "C" int tm_fingerprint(int device, const int64_t* host_table, const void* device_table, int64_t segments,
                              int64_t max_units, void* out, void* stream) {
  if (segments <= 0) return 0;
  if (max_units < 0) return static_cast<int>(cudaErrorInvalidValue);
  InlineTable inline_table{};
  if (device_table == nullptr) {
    if (host_table == nullptr || segments > kInlineSegments) return static_cast<int>(cudaErrorInvalidValue);
    for (int64_t i = 0; i < 3 * segments; ++i) inline_table.v[i] = host_table[i];
  }
  tm_launch::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(segments) * 2 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_units == 0) return 0;
  int sms = 0;
  err = tm_launch::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // about 16 words a thread a pass at least; at most kBlocksPerSM blocks an SM
  // for the largest segment (smaller ones leave their extra blocks idle)
  const int64_t needed = (max_units + kThreads * 16 - 1) / (kThreads * 16);
  const int64_t cap = kBlocksPerSM * sms;
  const unsigned blocks_x = static_cast<unsigned>(needed < cap ? needed : cap);
  const unsigned blocks_y = static_cast<unsigned>(segments < kMaxGridY ? segments : kMaxGridY);
  fingerprint_fold<<<dim3(blocks_x, blocks_y), kThreads, 0, s>>>(static_cast<const int64_t*>(device_table),
                                                                 inline_table, segments, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
