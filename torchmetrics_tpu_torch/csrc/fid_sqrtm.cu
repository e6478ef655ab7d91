// PSD matrix square root by coupled Newton-Schulz steps for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/sqrtm_kernel.py:_sqrtm_pallas
// (body _sqrtm_ns_kernel), which keeps Y, Z and T in VMEM and runs the whole
// solve in one launch. For a symmetric PSD (n, n) float32 matrix A:
//
//   c = max(||A||_F, 1e-30),  Y0 = A / c,  Z0 = I
//   repeat `iters` times:  T = (3 I - Z Y) / 2,  Y <- Y T,  Z <- T Z
//   sqrt(A) ~= Y * sqrt(c)
//
// At the Inception widths (n = 2048: 16.8 MB a matrix) Y, Z and T do not fit
// in an SM's 228 KB of shared memory, so the Hopper body is a loop of float32
// matrix products with fused epilogues, driven from the host, on one stream:
//
//   1 prologue launch: the partial sums of ||A||_F^2, one a block, and Z0 = I;
//   per step, 2 launches:
//     P = Z Y with the epilogue T = (3 I - P) / 2;
//     Y' = Y T and Z' = T Z together, a grid axis over the two products
//     (the last step computes only Y', scaled by sqrt(c)).
//
// That is 1 + 2 * iters launches (33 at 16 steps), with no allocation: the
// caller hands in the output and a workspace of 4 n^2 + kMaxPartials floats.
// Y0 = A / c is never stored: the first step reads A and divides the two
// products it feeds by c in their epilogues, where every block sums the
// prologue's partials in the same fixed order. So no grid-wide barrier and no
// atomic is needed, and a call is deterministic.
//
// Bound: operations. 16 steps are 47 products of n^3 float32 multiply-adds
// (the last step's Z is not needed): 807 GFLOP at n = 2048, 12.0 ms at
// 67 TFLOP/s without tensor cores; their bytes (each product reads two n^2
// matrices and writes one) take 0.7 ms at 3.35 TB/s.
//
// Design: a classic register-blocked SGEMM. A block owns a BM x BN tile of
// the output (128 x 128 with 8 x 8 values a thread, or 64 x 64 with 4 x 4
// where the 128-tile grid would leave SMs idle), stages BK = 8 deep slices of
// both operands in shared memory (the left one transposed and padded so the
// stores meet no bank conflict), double-buffered through registers, and
// accumulates with fmaf in ascending k. No tensor cores and no TF32: ten
// mantissa bits would lose the near-null directions of a rank-deficient
// covariance, which then drift to NaN sooner. Every load and store is bounds
// checked, so any n works without the identity padding the TPU kernel needs
// (padding is exact, so both give the same result).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPrologueThreads = 256;
constexpr int kMaxPartials = 1024;

// epilogue of a product: out = acc / div * mul, then for kT the step matrix
// T = (3 I - out) / 2. div and mul are 1 unless the product reads A (kDivC:
// divide by c) or ends the last step (kMulSqrtC: multiply by sqrt(c)); the
// two flags combine.
enum Epilogue { kPlain = 0, kT = 1 };
enum Scale { kOne = 0, kDivC = 1, kMulSqrtC = 2 };

struct Product {
  const float* a;
  const float* b;
  float* c;
  int epilogue;
  int scale;
};

struct Products {
  Product p[2];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

// Partial sums of squares of `a` (grid-stride, fixed order), one a block, and
// the identity into `eye`.
__global__ void __launch_bounds__(kPrologueThreads) ns_prologue(const float* __restrict__ a, float* __restrict__ eye,
                                                                float* __restrict__ partials, int n) {
  __shared__ float warp_sums[kPrologueThreads / 32];
  const int total = n * n;  // below 2^31: the entry point refuses larger n
  const int stride = gridDim.x * blockDim.x;
  float s = 0.0f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const float v = a[i];
    s = fmaf(v, v, s);
    eye[i] = (i / n == i % n) ? 1.0f : 0.0f;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.0f;
    for (int w = 0; w < kPrologueThreads / 32; ++w) b += warp_sums[w];
    partials[blockIdx.x] = b;
  }
}

// C = A B (+ epilogue) for n x n row-major float32 operands; blockIdx.z picks
// the product.
template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) ns_gemm(Products prods, const float* __restrict__ partials,
                                                                 int num_partials, int n) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kPad = 4;
  constexpr int kALoads = BM * BK / kThreads;
  constexpr int kBLoads = BK * BN / kThreads;
  constexpr int kGM = TM / 4;  // groups of four rows (columns) a thread owns
  constexpr int kGN = TN / 4;
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "tile loads must split evenly");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tiles are read as float4");

  __shared__ __align__(16) float As[2][BK][BM + kPad];
  __shared__ __align__(16) float Bs[2][BK][BN];
  __shared__ float s_div, s_mul;

  const Product pr = blockIdx.z == 0 ? prods.p[0] : prods.p[1];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  if (tid < 32) {
    float div = 1.0f, mul = 1.0f;
    if (pr.scale != kOne) {
      // ||A||_F^2 from the prologue's partials, in the same order in every block
      float s = 0.0f;
      for (int i = tid; i < num_partials; i += 32) s += partials[i];
      s = warp_sum(s);
      s = __shfl_sync(0xffffffffu, s, 0);
      const float c = fmaxf(sqrtf(s), 1e-30f);
      if (pr.scale & kDivC) div = c;
      if (pr.scale & kMulSqrtC) mul = sqrtf(c);
    }
    if (tid == 0) {
      s_div = div;
      s_mul = mul;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float ra[kALoads], rb[kBLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = row0 + idx / BK, k = k0 + idx % BK;
      ra[l] = (r < n && k < n) ? pr.a[static_cast<int64_t>(r) * n + k] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int k = k0 + idx / BN, cc = col0 + idx % BN;
      rb[l] = (k < n && cc < n) ? pr.b[static_cast<int64_t>(k) * n + cc] : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int idx = tid + l * kThreads;
      As[buf][idx % BK][idx / BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {
      const int idx = tid + l * kThreads;
      Bs[buf][idx / BN][idx % BN] = rb[l];
    }
  };

  const int tiles = (n + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < tiles) load((t + 1) * BK);  // next slice in flight during this one's products
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < kGM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[cur][k][g * (BM / kGM) + ty * 4]);
        av[g * 4 + 0] = v.x; av[g * 4 + 1] = v.y; av[g * 4 + 2] = v.z; av[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < kGN; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[cur][k][g * (BN / kGN) + tx * 4]);
        bv[g * 4 + 0] = v.x; bv[g * 4 + 1] = v.y; bv[g * 4 + 2] = v.z; bv[g * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < tiles) {
      store(cur ^ 1);  // the other buffer: its last readers finished before the previous barrier
      __syncthreads();
    }
  }

  const float div = s_div, mul = s_mul;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / 4) * (BM / kGM) + ty * 4 + i % 4;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cc = col0 + (j / 4) * (BN / kGN) + tx * 4 + j % 4;
      if (cc >= n) continue;
      float v = acc[i][j] / div * mul;
      if (pr.epilogue == kT) v = 0.5f * ((r == cc ? 3.0f : 0.0f) - v);
      pr.c[static_cast<int64_t>(r) * n + cc] = v;
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_gemm(const Products& prods, int count, const float* partials, int num_partials, int n,
                        cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM, count);
  ns_gemm<BM, BN, 8, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(prods, partials, num_partials, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tm_fid_sqrtm_max_partials() { return kMaxPartials; }

// a: float32 (n, n) symmetric PSD, row-major; out: float32 (n, n); ws: float32
// workspace of 4 n^2 + kMaxPartials; all contiguous on the current device.
// Runs `iters` coupled Newton-Schulz steps in 1 + 2 * iters launches on
// `stream` and returns the first failing launch's cudaError_t (0 on success).
extern "C" int tm_fid_sqrtm(const void* a, void* out, void* ws, int64_t n, int iters, void* stream) {
  if (n <= 0 || iters <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 46340) return static_cast<int>(cudaErrorInvalidValue);  // n^2 and row offsets stay within int range
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nn = n * n;
  float* w = static_cast<float*>(ws);
  float* t = w;
  float* y_alt = w + nn;
  float* z[2] = {w + 2 * nn, w + 3 * nn};
  float* partials = w + 4 * nn;
  float* y_out = static_cast<float*>(out);
  const float* src = static_cast<const float*>(a);

  int64_t blocks = (nn + kPrologueThreads * 4 - 1) / (kPrologueThreads * 4);
  const int64_t cap = 2 * static_cast<int64_t>(sms) < kMaxPartials ? 2 * static_cast<int64_t>(sms) : kMaxPartials;
  if (blocks > cap) blocks = cap;
  const int num_partials = static_cast<int>(blocks);
  const int ni = static_cast<int>(n);
  ns_prologue<<<static_cast<unsigned>(blocks), kPrologueThreads, 0, s>>>(src, z[0], partials, ni);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 128 x 128 tiles where they fill the card, 64 x 64 below
  const int64_t big_tiles = ((n + 127) / 128) * ((n + 127) / 128);
  const bool big = big_tiles >= sms;
  auto gemm = [&](const Products& p, int count) {
    return big ? launch_gemm<128, 128, 8, 8>(p, count, partials, num_partials, ni, s)
               : launch_gemm<64, 64, 4, 4>(p, count, partials, num_partials, ni, s);
  };

  // Y_k goes to y_out when iters - k is even, else to y_alt, so Y_iters lands
  // in `out` and no product writes the Y it reads; Z_k goes to z[k % 2]
  const float* y = src;  // Y0 = A / c: the first step's products divide by c
  for (int k = 1; k <= iters; ++k) {
    const bool first = k == 1, last = k == iters;
    const float* zk = z[(k - 1) % 2];
    Products p1{};
    p1.p[0] = {zk, y, t, kT, first ? kDivC : kOne};
    err = gemm(p1, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* y_next = (iters - k) % 2 == 0 ? y_out : y_alt;
    Products p2{};
    p2.p[0] = {y, t, y_next, kPlain, (first ? kDivC : kOne) | (last ? kMulSqrtC : kOne)};
    p2.p[1] = {t, zk, z[k % 2], kPlain, kOne};
    err = gemm(p2, last ? 1 : 2);
    if (err != cudaSuccess) return static_cast<int>(err);
    y = y_next;
  }
  return 0;
}
