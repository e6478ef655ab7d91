// Separable windowed sums (the SSIM moment core) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/ssim_kernel.py:_windowed_pallas
// (body _window_kernel), which runs one stacked image plane a grid step as
// two banded-matrix products on the MXU: out[m] = bh^T . x[m] . bw. With
// banded bh and bw that is a valid separable cross-correlation, and this
// kernel computes it directly:
//
//   y[m, i, j] = sum_b g_w[b] * ( sum_a g_h[a] * x[m, i + a, j + b] )
//
// for x (M, Hp, Wp) float32, taps g_h (kh,) and g_w (kw,), y (M, Hp-kh+1, Wp-kw+1).
// The banded product costs Hp + Wp multiply-adds a pixel (about 3,000 at
// 1080p); the direct form costs kh + kw (22 for SSIM's 11-tap gaussian).
//
// Bound: device-memory bytes. At the UVG 1080p update (M = 120 planes of
// 1,090 x 1,930) a call must read 1.010 GB and write 0.995 GB, 0.598 ms at
// 3.35 TB/s, against 11.0 GFLOP, 0.164 ms at the float32 rate of 67 TFLOP/s.
//
// Design: one block per (plane, 32 x 64 output tile). The block copies the
// haloed input tile (32 + kh - 1 rows, 64 + kw - 1 columns) into shared memory
// with coalesced asynchronous copies (cp.async): a thread keeps all its
// copies in flight at once, where a load through registers would wait for
// each before storing it. Neighbouring tiles' halos meet again in L2. The
// vertical pass writes a 32-row intermediate to shared memory: each thread
// walks one column and keeps 8 outputs and an 8-value window in registers,
// so it loads 8 + kh - 1 values for 8 outputs instead of 8 * kh. The
// horizontal pass does the same along rows (lane = row, warp = 8-column
// group, an odd row pitch so the 32 lanes hit 32 banks), stages the tile in
// shared memory, and the block stores it coalesced. Both passes accumulate in
// float32 with fmaf, in tap order; no tensor cores, since TF32 would break
// the E[x^2] - mu^2 cancellation downstream. The result differs from a
// banded matrix product or a convolution only by summation order.
//
// The taps live in shared memory, at most kMaxTaps = 65 a direction (a
// gaussian of sigma up to about 9); the caller refuses more. The 11 x 11
// window, SSIM's default, has its own instance with the tap loops unrolled.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32;  // = warp size: the horizontal pass maps lanes to rows
constexpr int kTileW = 64;
constexpr int kRows = 8;  // vertical-pass outputs a thread keeps in registers
constexpr int kCols = kTileW / (kThreads / 32);  // horizontal-pass outputs a thread keeps (8)
constexpr int kMaxTaps = 65;
constexpr int kOutPitch = kTileW + 1;
constexpr int64_t kDefaultSharedBytes = 48 * 1024;

static_assert(kTileH % kRows == 0, "tile height must be a multiple of the vertical register block");

__host__ __device__ inline int in_region_floats(int kh, int kw) {
  const int in = (kTileH + kh - 1) * (kTileW + kw - 1);
  const int out = kTileH * kOutPitch;  // the output stage reuses the input region
  return in > out ? in : out;
}

__host__ __device__ inline int mid_pitch(int kw) { return (kTileW + kw - 1) | 1; }

// 4-byte asynchronous copy from device memory into shared memory (sm_80+)
__device__ __forceinline__ void copy_async(float* smem_dst, const float* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src));
}

// KH, KW > 0 fix the tap counts at compile time (SSIM's 11-tap gaussian),
// so the tap loops unroll and the register windows shift by renaming;
// KH = KW = 0 takes them at run time.
template <int KH, int KW>
__global__ void __launch_bounds__(kThreads) windowed_sum(const float* __restrict__ x, const float* __restrict__ g_h,
                                                         const float* __restrict__ g_w, float* __restrict__ y,
                                                         int hp, int wp, int kh_arg, int kw_arg, int tiles_h,
                                                         int tiles_w) {
  extern __shared__ float smem[];
  const int kh = KH > 0 ? KH : kh_arg;
  const int kw = KW > 0 ? KW : kw_arg;
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int in_rows = kTileH + kh - 1;
  const int in_cols = kTileW + kw - 1;
  const int ld_mid = mid_pitch(kw);
  float* taps_h = smem;
  float* taps_w = smem + kMaxTaps;
  float* in = smem + 2 * kMaxTaps;
  float* mid = in + in_region_floats(kh, kw);
  float* out = in;

  const int tiles = tiles_h * tiles_w;
  const int64_t plane = blockIdx.x / tiles;
  const int tile = blockIdx.x - static_cast<int>(plane) * tiles;
  const int i0 = (tile / tiles_w) * kTileH;
  const int j0 = (tile % tiles_w) * kTileW;
  const float* xp = x + plane * hp * static_cast<int64_t>(wp);

  if (threadIdx.x < kh) taps_h[threadIdx.x] = g_h[threadIdx.x];
  if (threadIdx.x < kw) taps_w[threadIdx.x] = g_w[threadIdx.x];
  // warp w copies rows w, w + 8, ...; its lanes walk the row
  for (int r = threadIdx.x >> 5; r < in_rows; r += kThreads / 32) {
    const int gi = i0 + r;
    for (int c = threadIdx.x & 31; c < in_cols; c += 32) {
      const int gj = j0 + c;
      if (gi < hp && gj < wp) {
        copy_async(in + r * in_cols + c, xp + static_cast<int64_t>(gi) * wp + gj);
      } else {
        in[r * in_cols + c] = 0.0f;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // vertical pass: mid[r][c] = sum_a g_h[a] * in[r + a][c]
  for (int item = threadIdx.x; item < (kTileH / kRows) * in_cols; item += kThreads) {
    const int group = item / in_cols;
    const int c = item - group * in_cols;
    const int r0 = group * kRows;
    float w[kRows];
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      w[r] = in[(r0 + r) * in_cols + c];
      acc[r] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kh; ++a) {
      const float tap = taps_h[a];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(tap, w[r], acc[r]);
      if (a + 1 < kh) {
#pragma unroll
        for (int r = 0; r + 1 < kRows; ++r) w[r] = w[r + 1];
        w[kRows - 1] = in[(r0 + a + kRows) * in_cols + c];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) mid[(r0 + r) * ld_mid + c] = acc[r];
  }
  __syncthreads();

  // horizontal pass: out[r][c] = sum_b g_w[b] * mid[r][c + b]; `in` is free
  // from here on, so the output stage may overwrite it
  {
    const int r = threadIdx.x & 31;
    const int c0 = (threadIdx.x >> 5) * kCols;
    const float* row = mid + r * ld_mid + c0;
    float w[kCols];
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      w[c] = row[c];
      acc[c] = 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kw; ++b) {
      const float tap = taps_w[b];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(tap, w[c], acc[c]);
      if (b + 1 < kw) {
#pragma unroll
        for (int c = 0; c + 1 < kCols; ++c) w[c] = w[c + 1];
        w[kCols - 1] = row[b + kCols];
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[r * kOutPitch + c0 + c] = acc[c];
  }
  __syncthreads();

  float* yp = y + plane * ho * static_cast<int64_t>(wo);
  for (int idx = threadIdx.x; idx < kTileH * kTileW; idx += kThreads) {
    const int r = idx / kTileW;
    const int c = idx - r * kTileW;
    const int gi = i0 + r;
    const int gj = j0 + c;
    if (gi < ho && gj < wo) yp[static_cast<int64_t>(gi) * wo + gj] = out[r * kOutPitch + c];
  }
}

template <int KH, int KW>
cudaError_t launch(const float* x, const float* g_h, const float* g_w, float* y, int hp, int wp, int kh, int kw,
                   int tiles_h, int tiles_w, unsigned blocks, int64_t smem, cudaStream_t stream) {
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(windowed_sum<KH, KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  windowed_sum<KH, KW><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(x, g_h, g_w, y, hp, wp, kh, kw,
                                                                               tiles_h, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// The most taps a direction takes.
extern "C" int tm_ssim_windows_max_taps() { return kMaxTaps; }

// x: float32 (m, hp, wp), g_h: float32 (kh,), g_w: float32 (kw,), y: float32
// (m, hp - kh + 1, wp - kw + 1), all contiguous on the current device.
// Launches on `stream` and returns the launch's cudaError_t (0 on success);
// shapes outside what the kernel takes return cudaErrorInvalidValue.
extern "C" int tm_ssim_windows(const void* x, const void* g_h, const void* g_w, void* y, int64_t m, int64_t hp,
                               int64_t wp, int64_t kh, int64_t kw, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || hp < kh || wp < kw || hp > INT32_MAX ||
      wp > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0) return 0;
  const int64_t tiles_h = (hp - kh + 1 + kTileH - 1) / kTileH;
  const int64_t tiles_w = (wp - kw + 1 + kTileW - 1) / kTileW;
  const int64_t blocks = m * tiles_h * tiles_w;
  if (tiles_h * tiles_w > INT32_MAX || blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int ikh = static_cast<int>(kh);
  const int ikw = static_cast<int>(kw);
  const int64_t smem =
      (2 * kMaxTaps + in_region_floats(ikh, ikw) + kTileH * mid_pitch(ikw)) * static_cast<int64_t>(sizeof(float));
  const auto* xf = static_cast<const float*>(x);
  const auto* ghf = static_cast<const float*>(g_h);
  const auto* gwf = static_cast<const float*>(g_w);
  auto* yf = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  const int ih = static_cast<int>(hp);
  const int iw = static_cast<int>(wp);
  const int th = static_cast<int>(tiles_h);
  const int tw = static_cast<int>(tiles_w);
  if (ikh == 11 && ikw == 11) {
    return static_cast<int>(launch<11, 11>(xf, ghf, gwf, yf, ih, iw, ikh, ikw, th, tw, nb, smem, s));
  }
  return static_cast<int>(launch<0, 0>(xf, ghf, gwf, yf, ih, iw, ikh, ikw, th, tw, nb, smem, s));
}
