// Separable windowed sums (the SSIM moment core), and SSIM fused around them,
// for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/ssim_kernel.py:_windowed_pallas
// (body _window_kernel), which runs one stacked image plane a grid step as
// two banded-matrix products on the MXU: out[m] = bh^T . x[m] . bw. With
// banded bh and bw that is a valid separable cross-correlation, and this
// file computes it directly, in two entry points:
//
// - tm_ssim_windows, the generic windowed sum (SSIM when a gradient is
//   needed; its backward is the same kernel over the padded gradient):
//
//     y[m, i, j] = sum_b g_w[b] * ( sum_a g_h[a] * x[m, i + a, j + b] )
//
//   for x (M, Hp, Wp) float32, taps g_h (kh,), g_w (kw,), y (M, Hp-kh+1, Wp-kw+1);
//
// - tm_ssim_fused, SSIM without its gradient: it reads the UNPADDED preds
//   and target planes (P = B*C of them, H x W), reflects rows and columns at
//   the border itself (numpy's "reflect", for any pad, and n = 1), forms
//   x, y, x^2, y^2 and x*y as it reads them, runs the five windows, and
//   evaluates the SSIM map and cs = upper / lower per pixel in its epilogue
//   (c1, c2 from a device scalar, so a data_range taken from the data needs
//   no host sync). It writes per-(plane, block) float64 partial sums of SSIM
//   and cs over the cropped region, which the wrapper sums in a fixed order,
//   and with return_full_image the float32 SSIM map.
//
// Bound. Generic at the UVG 1080p update (120 planes of 1,090 x 1,930,
// 11 taps): bytes, 1.010 GB read and 0.995 GB written, 0.599 ms at 3.35 TB/s
// (11.0 GFLOP, 0.164 ms at 67 TFLOP/s). Fused at the same update (24 planes
// of 1,080 x 1,920): operations, about 12 GFLOP of windows, products and
// formula against 0.40 GB read, so about 0.18 ms at 67 TFLOP/s; the five
// moment planes never reach device memory.
//
// Design: a block owns a strip of 128 output columns of one plane (and a
// chunk of its rows, so that small planes still fill the card) and walks
// DOWN it. Input rows arrive in a ring in shared memory one step ahead of
// use, by 16-byte cp.async copies from the row's aligned-down address (the
// row's offset within the first 16 bytes is kept beside it; reflected edge
// strips of the fused entry copy 4 bytes a value): the copies of step s + 1
// fly while step s computes and stores. Each input row is read once per
// strip; the horizontal halo costs kw - 1 columns a strip. A step makes
// 16 output rows (8 fused): the vertical pass runs a register window down
// each column (8 rows a thread, 4 fused, each row loaded once and its
// products formed once) into a mid buffer; the horizontal pass gives a
// thread 4 consecutive outputs of a row, reads mid as float4 (a warp reads
// 512 contiguous bytes, conflict-free), and stores them as one 16-byte
// store where aligned. Both passes accumulate in float32 with fmaf, in tap
// order; no tensor cores, since TF32 would break the E[x^2] - mu^2
// cancellation downstream. The result differs from a banded matrix product
// or a convolution only by summation order. The 11 x 11 instance is
// compiled with its tap loops unrolled; other counts take them at run time.
//
// Any tap count up to the plane extent: when a window's ring and mid buffer
// do not fit in a block's shared memory (about 95 taps fused, 155 generic),
// the entry runs the two 1-D passes as two launches through a global
// intermediate (a column pass, then a row pass with the epilogue), each
// output a tap loop over cached loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStripW = 128;  // output columns a block owns: 32 lanes x kCols
constexpr int kCols = 4;      // horizontal pass: consecutive outputs a thread keeps (one float4)
constexpr int kPassBlocks = 1024;  // grid cap a plane of the two-pass kernels

// kIn input planes, kOut window planes, kStep output rows a step, kVRows
// vertical-pass rows a thread. Steps are short: at the UVG 1080p shapes,
// steps of 16 and 8 rows ran the generic entry in 0.784 ms and the fused
// one 11% faster than steps of 32 and 16 did (generic 0.925 ms;
// chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), and short steps leave the
// ring room for long windows.
template <bool kFused>
struct Shape;
template <>
struct Shape<false> {
  static constexpr int kIn = 1, kOut = 1, kStep = 16, kVRows = 8;
};
template <>
struct Shape<true> {
  static constexpr int kIn = 2, kOut = 5, kStep = 8, kVRows = 4;
};

struct Params {
  const float* x;      // generic: the planes; fused: preds
  const float* y;      // fused: target
  const float* x_end;  // one past the last float of x (and of y)
  const float* y_end;
  const float* g_h;
  const float* g_w;
  float* out;          // generic: the windows; fused: the SSIM map or null
  double* partials;    // fused: (P, parts, 2) sums of SSIM and cs
  const float* consts; // fused: {c1, c2} on the device, or null for c1, c2
  float c1, c2;
  int h, w;            // source plane extent (generic: Hp, Wp)
  int pad_h, pad_w;    // reflection pads (generic: 0)
  int kh, kw;
  int ho, wo;
  int crop_h, crop_w;  // fused: the crop offsets of the per-image means
  int strips, chunks, chunk_rows;
};

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int in_pitch(int kw) { return round4(kStripW + kw - 1 + 3); }
__host__ __device__ inline int mid_pitch(int kw) { return kStripW + 4 * ((kw + 3) / 4 + 1); }

template <bool kFused>
__host__ __device__ inline int ring_rows(int kh) {
  return 2 * Shape<kFused>::kStep + kh - 1;
}

template <bool kFused>
__host__ __device__ inline int64_t strip_smem_bytes(int kh, int kw) {
  using S = Shape<kFused>;
  const int ring = ring_rows<kFused>(kh);
  const int64_t floats = round4(kh) + round4(kw) + round4(S::kIn * ring) + round4(2 * (S::kStep + kh - 1)) +
                         static_cast<int64_t>(S::kIn) * ring * in_pitch(kw) +
                         static_cast<int64_t>(S::kOut) * S::kStep * mid_pitch(kw);
  return floats * static_cast<int64_t>(sizeof(float));
}

// numpy's "reflect" index of i on an axis of n: folded at period 2 (n - 1).
// One fold at each end covers every pad shorter than the axis without the
// integer division, which the edge strips would pay once a value.
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  if (i >= 0 && i < n) return i;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// the five moment values of one input pixel (generic: x alone)
template <bool kFused>
__device__ __forceinline__ void moments(float a, float b, float* v) {
  v[0] = a;
  if constexpr (kFused) {
    v[1] = b;
    v[2] = __fmul_rn(a, a);
    v[3] = __fmul_rn(b, b);
    v[4] = __fmul_rn(a, b);
  }
}

// SSIM and cs of one pixel from its five windowed moments, in the plain
// version's order of operations (no contraction into fma)
__device__ __forceinline__ void ssim_pixel(const float* m, float c1, float c2, float& ssim, float& cs) {
  const float mu_pp = __fmul_rn(m[0], m[0]);
  const float mu_tt = __fmul_rn(m[1], m[1]);
  const float mu_pt = __fmul_rn(m[0], m[1]);
  const float s_p = __fsub_rn(m[2], mu_pp);
  const float s_t = __fsub_rn(m[3], mu_tt);
  const float s_pt = __fsub_rn(m[4], mu_pt);
  const float upper = __fadd_rn(__fmul_rn(2.0f, s_pt), c2);
  const float lower = __fadd_rn(__fadd_rn(s_p, s_t), c2);
  const float num = __fmul_rn(__fadd_rn(__fmul_rn(2.0f, mu_pt), c1), upper);
  const float den = __fmul_rn(__fadd_rn(__fadd_rn(mu_pp, mu_tt), c1), lower);
  ssim = __fdiv_rn(num, den);
  cs = __fdiv_rn(upper, lower);
}

// the block's two sums, reduced in a fixed order, into partials[slot]
__device__ void block_sums(double a, double b, double* partials, int64_t slot) {
  __shared__ double red[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ta = 0.0, tb = 0.0;
    for (int i = 0; i < kWarps; ++i) {
      ta += red[0][i];
      tb += red[1][i];
    }
    partials[2 * slot] = ta;
    partials[2 * slot + 1] = tb;
  }
}

// 4 consecutive outputs of one row: sum_b g[b] * m[c + b], m 16-byte aligned
template <int KW>
__device__ __forceinline__ void row_window(const float* m, const float* taps, int kw_arg, float* acc) {
  const int kw = KW > 0 ? KW : kw_arg;
  const int nq = (kw + 3) / 4;
  float4 a = *reinterpret_cast<const float4*>(m);
#pragma unroll
  for (int q = 0; q < nq; ++q) {
    const float4 b = *reinterpret_cast<const float4*>(m + 4 * (q + 1));
    const float win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (4 * q + s < kw) {
        const float g = taps[4 * q + s];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(g, win[c + s], acc[c]);
      }
    }
    a = b;
  }
}

// 4 consecutive floats to dst[0..n), one 16-byte store where aligned
__device__ __forceinline__ void store_row(float* dst, const float* v, int n) {
  if (n >= kCols && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < n) dst[c] = v[c];
  }
}

// KH, KW > 0 fix the tap counts at compile time (SSIM's 11-tap gaussian);
// 0 takes them at run time.
template <bool kFused, int KH, int KW>
__global__ void __launch_bounds__(kThreads) strip_windows(const Params p) {
  using S = Shape<kFused>;
  constexpr int kIn = S::kIn, kOut = S::kOut, kStep = S::kStep, kVRows = S::kVRows;
  extern __shared__ __align__(16) float smem[];
  const int kh = KH > 0 ? KH : p.kh;
  const int kw = KW > 0 ? KW : p.kw;
  const int mw = kStripW + kw - 1;  // mid columns a strip needs
  const int ip = in_pitch(kw);
  const int mp = mid_pitch(kw);
  const int ring = ring_rows<kFused>(kh);
  float* taps_h = smem;
  float* taps_w = taps_h + round4(kh);
  int* shifts = reinterpret_cast<int*>(taps_w + round4(kw));  // [kIn][ring]
  int2* rowoff = reinterpret_cast<int2*>(shifts + round4(kIn * ring));  // [kStep + kh - 1]
  float* in = reinterpret_cast<float*>(reinterpret_cast<int*>(rowoff) + round4(2 * (kStep + kh - 1)));
  float* mid = in + kIn * ring * ip;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per_plane = p.chunks * p.strips;
  const int plane = blockIdx.x / per_plane;
  const int rem = blockIdx.x - plane * per_plane;
  const int chunk = rem / p.strips;
  const int j0 = (rem - chunk * p.strips) * kStripW;
  const int r_begin = chunk * p.chunk_rows;
  const int r_end = min(p.ho, r_begin + p.chunk_rows);
  const int hp = p.h + 2 * p.pad_h;
  const int64_t plane_elems = static_cast<int64_t>(p.h) * p.w;
  float c1 = p.c1, c2 = p.c2;
  if (kFused && p.consts != nullptr) {
    c1 = p.consts[0];
    c2 = p.consts[1];
  }

  for (int i = tid; i < kh; i += kThreads) taps_h[i] = p.g_h[i];
  for (int i = tid; i < kw; i += kThreads) taps_w[i] = p.g_w[i];
  for (int i = tid; i < kIn * ring; i += kThreads) shifts[i] = 0;
  __syncthreads();

  // copy padded rows [lo, hi) of every input plane into their ring slots
  auto issue = [&](int lo, int hi) {
    hi = min(hi, hp);
    for (int item = warp; item < (hi - lo) * kIn; item += kWarps) {
      const int q = kIn == 1 ? 0 : item % kIn;
      const int row = lo + item / kIn;
      const int slot = (row - r_begin) % ring;
      float* dst = in + (q * ring + slot) * ip;
      const float* start = q == 0 ? p.x : p.y;  // 16-byte aligned
      const float* end = q == 0 ? p.x_end : p.y_end;
      const int src_row = kFused ? reflect(row - p.pad_h, p.h) : row;
      const float* src = start + plane * plane_elems + static_cast<int64_t>(src_row) * p.w;
      const int s0 = j0 - p.pad_w;
      if (!kFused || (s0 >= 0 && s0 + mw <= p.w)) {
        const float* first = src + s0;
        const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(first) >> 2) & 3);
        const float* aligned = first - shift;
        const int nv = (shift + mw + 3) >> 2;
        for (int v = lane; v < nv; v += 32) {
          const float* g = aligned + 4 * v;
          const int64_t left = end - g;  // floats left in the tensor
          const int bytes = left >= 4 ? 16 : (left > 0 ? static_cast<int>(left) * 4 : 0);
          copy16(dst + 4 * v, bytes > 0 ? g : start, bytes);
        }
        if (lane == 0) shifts[q * ring + slot] = shift;
      } else {  // a strip at the border: reflected columns one value at a time
        for (int c = lane; c < mw; c += 32) copy4(dst + c, src + reflect(s0 + c, p.w));
        if (lane == 0) shifts[q * ring + slot] = 0;
      }
    }
  };

  double sum_ssim = 0.0, sum_cs = 0.0;
  const int steps = (r_end - r_begin + kStep - 1) / kStep;
  issue(r_begin, r_begin + kStep + kh - 1);
  commit();
  for (int s = 0; s < steps; ++s) {
    const int o = r_begin + s * kStep;
    if (s + 1 < steps) issue(o + kStep + kh - 1, o + 2 * kStep + kh - 1);
    commit();
    wait_prior();
    __syncthreads();
    // where each of the step's input rows starts in the ring, both planes
    const int slot0 = (o - r_begin) % ring;
    for (int t = tid; t < kStep + kh - 1; t += kThreads) {
      const int slot = slot0 + t < ring ? slot0 + t : slot0 + t - ring;
      rowoff[t] = make_int2(slot * ip + shifts[slot], kFused ? (ring + slot) * ip + shifts[ring + slot] : 0);
    }
    __syncthreads();

    // vertical pass: mid[p][r][c] = sum_a g_h[a] * moment_p(in[o + r + a][c])
    for (int item = tid; item < (kStep / kVRows) * mw; item += kThreads) {
      const int grp = item / mw;
      const int c = item - grp * mw;
      const int r0 = grp * kVRows;
      auto fetch = [&](int t, float* v) {
        const int2 off = rowoff[t];
        moments<kFused>(in[off.x + c], kFused ? in[off.y + c] : 0.0f, v);
      };
      float win[kVRows][kOut];
      float acc[kVRows][kOut];
#pragma unroll
      for (int r = 0; r < kVRows; ++r) {
        fetch(r0 + r, win[r]);
#pragma unroll
        for (int q = 0; q < kOut; ++q) acc[r][q] = 0.0f;
      }
#pragma unroll
      for (int a = 0; a < kh; ++a) {
        const float g = taps_h[a];
#pragma unroll
        for (int r = 0; r < kVRows; ++r)
#pragma unroll
          for (int q = 0; q < kOut; ++q) acc[r][q] = fmaf(g, win[r][q], acc[r][q]);
        if (a + 1 < kh) {
#pragma unroll
          for (int r = 0; r + 1 < kVRows; ++r)
#pragma unroll
            for (int q = 0; q < kOut; ++q) win[r][q] = win[r + 1][q];
          fetch(r0 + a + kVRows, win[kVRows - 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kVRows; ++r)
#pragma unroll
        for (int q = 0; q < kOut; ++q) mid[(q * kStep + r0 + r) * mp + c] = acc[r][q];
    }
    __syncthreads();

    // horizontal pass and epilogue: a warp a row, 4 outputs a lane
    const int jc = j0 + lane * kCols;
    for (int rr = warp; rr < kStep; rr += kWarps) {
      const int i = o + rr;
      if (i >= r_end || jc >= p.wo) continue;
      const int n = min(kCols, p.wo - jc);
      float acc[kOut][kCols];
#pragma unroll
      for (int q = 0; q < kOut; ++q) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[q][c] = 0.0f;
        row_window<KW>(mid + (q * kStep + rr) * mp + lane * kCols, taps_w, kw, acc[q]);
      }
      const int64_t at = (static_cast<int64_t>(plane) * p.ho + i) * p.wo + jc;
      if constexpr (!kFused) {
        store_row(p.out + at, acc[0], n);
      } else {
        float ssim[kCols];
        const bool row_in = i >= p.crop_h && i < p.ho - p.crop_h;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float m[kOut] = {acc[0][c], acc[1][c], acc[2][c], acc[3][c], acc[4][c]};
          float cs;
          ssim_pixel(m, c1, c2, ssim[c], cs);
          const int j = jc + c;
          if (row_in && c < n && j >= p.crop_w && j < p.wo - p.crop_w) {
            sum_ssim += ssim[c];
            sum_cs += cs;
          }
        }
        if (p.out != nullptr) store_row(p.out + at, ssim, n);
      }
    }
  }
  if constexpr (kFused) block_sums(sum_ssim, sum_cs, p.partials, blockIdx.x);
}

// Two-pass path, pass 1: t[plane][q][i][j] = sum_a g_h[a] * moment_q(x[i + a][j])
// over the source columns (fused: rows reflected).
template <bool kFused>
__global__ void __launch_bounds__(kThreads) column_pass(const Params p, float* __restrict__ t) {
  using S = Shape<kFused>;
  const int64_t per_plane = static_cast<int64_t>(p.ho) * p.w;
  const int plane = blockIdx.y;
  const int64_t plane_elems = static_cast<int64_t>(p.h) * p.w;
  const float* xs = p.x + plane * plane_elems;
  const float* ys = kFused ? p.y + plane * plane_elems : p.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < per_plane;
       e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int i = static_cast<int>(e / p.w);
    const int j = static_cast<int>(e - static_cast<int64_t>(i) * p.w);
    float acc[S::kOut] = {};
    for (int a = 0; a < p.kh; ++a) {
      const int r = kFused ? reflect(i + a - p.pad_h, p.h) : i + a;
      const int64_t at = static_cast<int64_t>(r) * p.w + j;
      float v[S::kOut];
      moments<kFused>(__ldg(xs + at), kFused ? __ldg(ys + at) : 0.0f, v);
      const float g = __ldg(p.g_h + a);
#pragma unroll
      for (int q = 0; q < S::kOut; ++q) acc[q] = fmaf(g, v[q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < S::kOut; ++q) t[(static_cast<int64_t>(plane) * S::kOut + q) * per_plane + e] = acc[q];
  }
}

// Two-pass path, pass 2: the row window over t (fused: columns reflected),
// then the generic store or the fused epilogue.
template <bool kFused>
__global__ void __launch_bounds__(kThreads) row_pass(const Params p, const float* __restrict__ t) {
  using S = Shape<kFused>;
  const int64_t per_plane = static_cast<int64_t>(p.ho) * p.wo;
  const int64_t t_plane = static_cast<int64_t>(p.ho) * p.w;
  const int plane = blockIdx.y;
  float c1 = p.c1, c2 = p.c2;
  if (kFused && p.consts != nullptr) {
    c1 = p.consts[0];
    c2 = p.consts[1];
  }
  double sum_ssim = 0.0, sum_cs = 0.0;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < per_plane;
       e += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int i = static_cast<int>(e / p.wo);
    const int j = static_cast<int>(e - static_cast<int64_t>(i) * p.wo);
    float acc[S::kOut] = {};
    for (int b = 0; b < p.kw; ++b) {
      const int col = kFused ? reflect(j + b - p.pad_w, p.w) : j + b;
      const float g = __ldg(p.g_w + b);
#pragma unroll
      for (int q = 0; q < S::kOut; ++q)
        acc[q] = fmaf(g, __ldg(t + (static_cast<int64_t>(plane) * S::kOut + q) * t_plane + static_cast<int64_t>(i) * p.w + col), acc[q]);
    }
    const int64_t at = static_cast<int64_t>(plane) * per_plane + e;
    if constexpr (!kFused) {
      p.out[at] = acc[0];
    } else {
      float ssim, cs;
      ssim_pixel(acc, c1, c2, ssim, cs);
      if (p.out != nullptr) p.out[at] = ssim;
      if (i >= p.crop_h && i < p.ho - p.crop_h && j >= p.crop_w && j < p.wo - p.crop_w) {
        sum_ssim += ssim;
        sum_cs += cs;
      }
    }
  }
  if constexpr (kFused) block_sums(sum_ssim, sum_cs, p.partials, static_cast<int64_t>(plane) * gridDim.x + blockIdx.x);
}

using Kernel = void (*)(Params);

// What a plan asks the CUDA runtime, asked once: each device's SM count and
// shared-memory cap, each strip instance's raised cap, and its occupancy at
// the last shared-memory size asked (a call's host path is most of a small
// launch's time).
constexpr int kMaxDevices = 64;
constexpr int kInstances = 4;
struct DeviceMemo {
  int sms = 0, optin = 0;
  bool raised[kInstances] = {};
  int64_t smem[kInstances] = {};
  int occupancy[kInstances] = {};
};
DeviceMemo g_memo[kMaxDevices];
std::mutex g_memo_lock;

int instance_index(bool fused, bool eleven) { return (fused ? 2 : 0) + (eleven ? 1 : 0); }

struct Plan {
  bool two_pass;
  Kernel kernel;
  int64_t smem;
  dim3 grid;       // strip kernel; or the row pass
  dim3 col_grid;   // the column pass
  int strips, chunks, chunk_rows;
  int64_t parts;   // partial-sum slots a plane (fused)
};

template <bool kFused>
cudaError_t make_plan(int64_t planes, int64_t ho, int64_t wo, int64_t w, int kh, int kw, Plan* plan) {
  using S = Shape<kFused>;
  if (planes <= 0) {  // nothing to launch: no launch, no partial sums
    *plan = Plan{};
    return cudaSuccess;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(g_memo_lock);
  DeviceMemo& memo = g_memo[device];
  if (memo.sms == 0) {
    int sms = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    memo.optin = optin;
    memo.sms = sms;
  }
  const int sms = memo.sms, optin = memo.optin;
  const int64_t smem = strip_smem_bytes<kFused>(kh, kw);
  const int64_t static_bytes = 2 * kWarps * static_cast<int64_t>(sizeof(double));
  if (smem + static_bytes > optin) {  // too long a window for the ring: two launches
    if (planes > 65535) return cudaErrorInvalidValue;  // grid.y
    plan->two_pass = true;
    plan->col_grid = dim3(static_cast<unsigned>(std::min<int64_t>((ho * w + kThreads - 1) / kThreads, kPassBlocks)),
                          static_cast<unsigned>(planes));
    plan->grid = dim3(static_cast<unsigned>(std::min<int64_t>((ho * wo + kThreads - 1) / kThreads, kPassBlocks)),
                      static_cast<unsigned>(planes));
    plan->parts = plan->grid.x;
    return cudaSuccess;
  }
  plan->two_pass = false;
  plan->smem = smem;
  const bool eleven = kh == 11 && kw == 11;
  plan->kernel = eleven ? strip_windows<kFused, 11, 11> : strip_windows<kFused, 0, 0>;
  const int at = instance_index(kFused, eleven);
  if (!memo.raised[at]) {  // the instance may take up to the device's cap
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(plan->kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(optin - static_bytes));
    if (err != cudaSuccess) return err;
    memo.raised[at] = true;
  }
  if (memo.smem[at] != smem) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, plan->kernel, kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    memo.occupancy[at] = blocks;
    memo.smem[at] = smem;
  }
  const int occupancy = memo.occupancy[at];
  // enough row chunks for about eight waves, one step of rows at the least
  const int64_t strips = (wo + kStripW - 1) / kStripW;
  const int64_t slots = static_cast<int64_t>(sms) * std::max(occupancy, 1);
  const int64_t items = planes * strips;
  int64_t chunks = std::min<int64_t>(std::max<int64_t>((8 * slots + items - 1) / items, 1), (ho + S::kStep - 1) / S::kStep);
  int64_t rows = (ho + chunks - 1) / chunks;
  rows = (rows + S::kStep - 1) / S::kStep * S::kStep;
  chunks = (ho + rows - 1) / rows;
  if (items * chunks > INT32_MAX) return cudaErrorInvalidValue;
  plan->strips = static_cast<int>(strips);
  plan->chunks = static_cast<int>(chunks);
  plan->chunk_rows = static_cast<int>(rows);
  plan->grid = dim3(static_cast<unsigned>(items * chunks));
  plan->parts = strips * chunks;
  return cudaSuccess;
}

template <bool kFused>
cudaError_t run(const Plan& plan, Params p, float* tmp, int64_t planes, cudaStream_t s) {
  if (!plan.two_pass) {
    p.strips = plan.strips;
    p.chunks = plan.chunks;
    p.chunk_rows = plan.chunk_rows;
    plan.kernel<<<plan.grid, kThreads, static_cast<size_t>(plan.smem), s>>>(p);
    return cudaGetLastError();
  }
  if (tmp == nullptr) return cudaErrorInvalidValue;
  column_pass<kFused><<<plan.col_grid, kThreads, 0, s>>>(p, tmp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_pass<kFused><<<plan.grid, kThreads, 0, s>>>(p, tmp);
  return cudaGetLastError();
}

bool extents_ok(int64_t h, int64_t w, int64_t pad_h, int64_t pad_w, int64_t kh, int64_t kw) {
  return kh >= 1 && kw >= 1 && pad_h >= 0 && pad_w >= 0 && h >= 1 && w >= 1 && h + 2 * pad_h >= kh &&
         w + 2 * pad_w >= kw && h + 2 * pad_h <= INT32_MAX / 2 && w + 2 * pad_w <= INT32_MAX / 2;
}

}  // namespace

// How an entry will run on the current device: *launches (0 for no planes,
// 1, or 2 for the two-pass path, which needs a float32 intermediate of
// *tmp_floats) and
// *parts, the fused entry's partial-sum slots a plane. `fused` 0 takes the
// generic entry's extents (h, w = Hp, Wp, no pads). Returns a cudaError_t.
extern "C" int tm_ssim_plan(int fused, int64_t planes, int64_t h, int64_t w, int64_t pad_h, int64_t pad_w, int64_t kh,
                            int64_t kw, int* launches, int64_t* parts, int64_t* tmp_floats) {
  if (!extents_ok(h, w, pad_h, pad_w, kh, kw) || planes < 0 || (!fused && (pad_h != 0 || pad_w != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ho = h + 2 * pad_h - kh + 1;
  const int64_t wo = w + 2 * pad_w - kw + 1;
  Plan plan{};
  const cudaError_t err = fused ? make_plan<true>(planes, ho, wo, w, static_cast<int>(kh), static_cast<int>(kw), &plan)
                                : make_plan<false>(planes, ho, wo, w, static_cast<int>(kh), static_cast<int>(kw), &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launches = planes == 0 ? 0 : plan.two_pass ? 2 : 1;
  *parts = plan.parts;
  *tmp_floats = plan.two_pass ? planes * (fused ? 5 : 1) * ho * w : 0;
  return 0;
}

// x: float32 (m, hp, wp), g_h: float32 (kh,), g_w: float32 (kw,), y: float32
// (m, hp - kh + 1, wp - kw + 1), tmp: the plan's intermediate or null, all
// contiguous on the current device, x 16-byte aligned. Launches on `stream`
// and returns the first failing call's cudaError_t (0 on success).
extern "C" int tm_ssim_windows(const void* x, const void* g_h, const void* g_w, void* y, void* tmp, int64_t m,
                               int64_t hp, int64_t wp, int64_t kh, int64_t kw, void* stream) {
  if (!extents_ok(hp, wp, 0, 0, kh, kw)) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  Plan plan{};
  cudaError_t err = make_plan<false>(m, hp - kh + 1, wp - kw + 1, wp, static_cast<int>(kh), static_cast<int>(kw), &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.x = static_cast<const float*>(x);
  p.x_end = p.x + m * hp * wp;
  p.g_h = static_cast<const float*>(g_h);
  p.g_w = static_cast<const float*>(g_w);
  p.out = static_cast<float*>(y);
  p.h = static_cast<int>(hp);
  p.w = static_cast<int>(wp);
  p.kh = static_cast<int>(kh);
  p.kw = static_cast<int>(kw);
  p.ho = static_cast<int>(hp - kh + 1);
  p.wo = static_cast<int>(wp - kw + 1);
  return static_cast<int>(run<false>(plan, p, static_cast<float*>(tmp), m, static_cast<cudaStream_t>(stream)));
}

// x, y: float32 (planes, h, w) preds and target; taps as above; consts:
// float32 {c1, c2} on the device, or null to use c1, c2; map: float32
// (planes, ho, wo) SSIM map or null; partials: float64 (planes, parts, 2);
// tmp: the plan's intermediate or null; ho = h + 2 pad_h - kh + 1 (wo alike);
// the sums cover rows [crop_h, ho - crop_h) and columns [crop_w, wo - crop_w).
// All contiguous on the current device, x and y 16-byte aligned. Launches on
// `stream`; returns the first failing call's cudaError_t (0 on success).
extern "C" int tm_ssim_fused(const void* x, const void* y, const void* g_h, const void* g_w, const void* consts,
                             float c1, float c2, void* map, void* partials, void* tmp, int64_t planes, int64_t h,
                             int64_t w, int64_t pad_h, int64_t pad_w, int64_t kh, int64_t kw, int64_t crop_h,
                             int64_t crop_w, void* stream) {
  if (!extents_ok(h, w, pad_h, pad_w, kh, kw)) return static_cast<int>(cudaErrorInvalidValue);
  if (planes <= 0) return 0;
  const int64_t ho = h + 2 * pad_h - kh + 1;
  const int64_t wo = w + 2 * pad_w - kw + 1;
  Plan plan{};
  cudaError_t err = make_plan<true>(planes, ho, wo, w, static_cast<int>(kh), static_cast<int>(kw), &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.x_end = p.x + planes * h * w;
  p.y_end = p.y + planes * h * w;
  p.g_h = static_cast<const float*>(g_h);
  p.g_w = static_cast<const float*>(g_w);
  p.out = static_cast<float*>(map);
  p.partials = static_cast<double*>(partials);
  p.consts = static_cast<const float*>(consts);
  p.c1 = c1;
  p.c2 = c2;
  p.h = static_cast<int>(h);
  p.w = static_cast<int>(w);
  p.pad_h = static_cast<int>(pad_h);
  p.pad_w = static_cast<int>(pad_w);
  p.kh = static_cast<int>(kh);
  p.kw = static_cast<int>(kw);
  p.ho = static_cast<int>(ho);
  p.wo = static_cast<int>(wo);
  p.crop_h = static_cast<int>(crop_h);
  p.crop_w = static_cast<int>(crop_w);
  return static_cast<int>(run<true>(plan, p, static_cast<float*>(tmp), planes, static_cast<cudaStream_t>(stream)));
}
