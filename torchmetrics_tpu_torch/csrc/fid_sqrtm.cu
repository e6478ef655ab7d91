// PSD matrix square root by coupled Newton-Schulz steps in float64 on
// Hopper's FP64 tensor cores (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel torchmetrics_tpu/ops/sqrtm_kernel.py:_sqrtm_pallas
// (body _sqrtm_ns_kernel), which keeps Y, Z and T in VMEM and runs 16 float32
// steps in one launch. For a symmetric PSD (n, n) float64 matrix A:
//
//   c = max(||A||_F, 1e-30),  Y0 = A / c,  Z0 = I
//   repeat `iters` times:  T = (3 I - Z Y) / 2,  Y <- Y T,  Z <- T Z
//   sqrt(A) ~= Y * sqrt(c)
//
// Why float64, and 22 steps (ops/sqrtm_kernel.py: KERNEL_ITERS). An
// eigenvalue p of A / c converges after about log(1/p) / (2 log 1.5) steps,
// and a covariance with one dominant mode puts most eigenvalues far below
// it. In float32 the iteration then stops near 1e-3 of FID whatever the
// step count; in float64 it converges. CPU accuracy runs (FID's relative
// error against float64 eigh, F = 2048, covariance rounded to float32):
// dominant mode 1.37e-3 at 16 float32 steps, 9.1e-4 at 24, and 2.3e-5 at 24
// float64 steps; F = 256 with a dominant mode 3.45e-3 at 16 float32 steps.
// chip_smoke.py's sweep of the float64 plain body on an H100 (F = 2048):
// the dominant mode 3.2e-4 at 20 steps, 8.9e-5 at 22, 1.5e-5 at 24; a
// rank-999 covariance about 2e-7 up to 26 steps and 1.2e-4 at 28, where
// the negative eigenvalues rounding leaves have grown 2.25x a step. 22 is
// the least count that holds every checked shape within 2.5e-4. Symmetrising
// T, Y and Z after every step (what computing one triangle of each product
// amounts to) made the iteration blow up in the CPU runs, so every product
// here is computed whole.
//
// At the Inception widths (n = 2048: 33.5 MB a float64 matrix) Y, Z and T do
// not fit in shared memory, so the Hopper body is a loop of float64 matrix
// products with fused epilogues, driven from the host, on one stream:
//
//   1 prologue launch: the partial sums of ||A||_F^2, one a block;
//   the first step, 2 launches: Z0 = I, so P = Z0 Y0 = A / c and Z1 = T1 Z0
//     = T1 need no product (multiplying by I is exact): one elementwise
//     launch writes T1 = (3 I - A / c) / 2 into T and into Z1, then
//     Y1 = Y0 T1, a product of A divided by c in its epilogue;
//   every later step, 2 launches:
//     P = Z Y with the epilogue T = (3 I - P) / 2;
//     Y' = Y T and Z' = T Z together, a grid axis over the two products
//     (the last step computes only Y', scaled by sqrt(c)).
//
// That is 1 + 2 * iters launches (45 at 22 steps) and 3 * iters - 3 matrix
// products, with no allocation: the caller hands in the output and a
// workspace of 4 n^2 + kMaxPartials doubles. Y0 = A / c is never stored.
// Every block that needs c sums the prologue's partials in the same fixed
// order, so no grid-wide barrier and no atomic is needed, and a call is
// deterministic.
//
// Bound: operations. The iteration as written is 3K - 1 products of n^3
// float64 multiply-adds (the last step's Z is not needed), and 3K - 3 once
// the first step's two products by Z0 = I are skipped: at n = 2048 and
// K = 22, 63 products, 1.08 TFLOP, 16.2 ms at the 67 TFLOP/s of the H100
// SXM's FP64 tensor cores (16.7 ms for 65). Their bytes (each product reads
// two n^2 matrices and writes one) take 1.9 ms at 3.35 TB/s.
//
// Design: each product is a DGEMM on mma.sync.m16n8k4 (DMMA; Hopper's wgmma
// has no float64 type). A block owns a BM x BN tile of the output (128 x 128
// with 8 warps of 64 x 32, or 64 x 64 with 4 warps of 32 x 32 where the
// 128-tile grid would leave SMs idle) and accumulates in float64 registers.
// Operand tiles BK = 16 deep stream through a ring of cp.async stages in
// dynamic shared memory (4 stages, 150 KB, at 128 x 128): one barrier per
// 16-deep slice, three slices in flight, and each warp's mma fragments
// double-buffered in registers, so shared-memory loads overlap the tensor
// cores' work. The grid is persistent (as many blocks as are resident, each
// walking its tiles down the columns of the output), and a block issues the
// first slices of its next tile before it stores the current one, so tile
// boundaries do not drain the SM. Row strides of the staged tiles are 4
// doubles past a multiple of 16, so each half-warp's 8-byte fragment loads
// fall on 16 distinct bank pairs. Loads are bounds checked (cp.async
// zero-fills what lies outside the matrix: 16-byte copies for even n,
// 8-byte copies for odd n or a misaligned input), so any n works without
// the identity padding the TPU kernel needs (padding is exact, so both give
// the same result). No TF32 and no split products: they reach float32
// accuracy at best.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPrologueThreads = 256;
constexpr int kMaxPartials = 1024;
constexpr int kPad = 4;  // doubles past a multiple of 16 in every staged row
constexpr int kMaxDevices = 64;

// epilogue of a product: out = acc * scale, then for kT the step matrix
// T = (3 I - out) / 2. scale is 1 unless the product reads A (kDivC: 1 / c)
// or ends the last step (kMulSqrtC: sqrt(c)); the two flags combine.
enum Epilogue { kPlain = 0, kT = 1 };
enum Scale { kOne = 0, kDivC = 1, kMulSqrtC = 2 };

struct Product {
  const double* a;
  const double* b;
  double* c;
  int epilogue;
  int scale;
};

struct Products {
  Product p[2];
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

// c = max(||A||_F, 1e-30) from the prologue's partials, summed by one warp
// in the same order in every block
__device__ __forceinline__ double frobenius(const double* __restrict__ partials, int num_partials, int lane) {
  double s = 0.0;
  for (int i = lane; i < num_partials; i += 32) s += partials[i];
  s = warp_sum(s);
  return fmax(sqrt(__shfl_sync(0xffffffffu, s, 0)), 1e-30);
}

// Partial sums of squares of `a` (grid-stride, fixed order), one a block.
__global__ void __launch_bounds__(kPrologueThreads) ns_prologue(const double* __restrict__ a,
                                                                double* __restrict__ partials, int n) {
  __shared__ double warp_sums[kPrologueThreads / 32];
  const int total = n * n;  // below 2^31: the entry point refuses larger n
  const int stride = gridDim.x * blockDim.x;
  double s = 0.0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const double v = a[i];
    s = fma(v, v, s);
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double b = 0.0;
    for (int w = 0; w < kPrologueThreads / 32; ++w) b += warp_sums[w];
    partials[blockIdx.x] = b;
  }
}

// The first step's T1 = (3 I - A / c) / 2, into `t` and `z1` (Z1 = T1 Z0 = T1).
__global__ void __launch_bounds__(kPrologueThreads) ns_first_step(const double* __restrict__ a, double* __restrict__ t,
                                                                  double* __restrict__ z1,
                                                                  const double* __restrict__ partials,
                                                                  int num_partials, int n) {
  __shared__ double s_c;
  if (threadIdx.x < 32) {
    const double c = frobenius(partials, num_partials, threadIdx.x);
    if (threadIdx.x == 0) s_c = c;
  }
  __syncthreads();
  const double c = s_c;
  const int total = n * n;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const double v = 0.5 * ((i / n == i % n ? 3.0 : 0.0) - a[i] / c);
    t[i] = v;
    z1[i] = v;
  }
}

// cp.async of `bytes` (16 or 8) from global to shared memory; `valid` false
// copies nothing and fills the destination with zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(double* smem, const double* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// d += a b for one 16 x 8 x 4 float64 tile: a holds rows g and g + 8 of
// column t, b row t of column g, d rows g, g, g + 8, g + 8 of columns 2t,
// 2t + 1 (g = lane / 4, t = lane % 4). The k8 and k16 shapes ran no faster
// here.
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

template <int BM, int BN, int kStages, int kBK>
constexpr int gemm_smem_bytes() {
  return kStages * (BM * (kBK + kPad) + kBK * (BN + kPad)) * static_cast<int>(sizeof(double));
}

// C = A B (+ epilogue) for n x n row-major float64 operands, `count` (1 or
// 2) products of BM x BN tiles each. The grid is persistent: block b takes
// tiles b, b + gridDim.x, ..., consecutive tiles walking down a column of
// one product, and issues the first slices of its next tile before it
// stores the current one. kVec: n is even and every matrix starts 16-byte
// aligned, so every row does, and operands are staged 16 bytes a copy.
template <int BM, int BN, int WM, int WN, int kStages, int kBK, bool kVec>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, 1)
    ns_dgemm(Products prods, int count, const double* __restrict__ partials, int num_partials, int n) {
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  constexpr int kSA = kBK + kPad;  // row stride of a staged A slice (BM x BK)
  constexpr int kSB = BN + kPad;   // row stride of a staged B slice (BK x BN)
  constexpr int kMT = WM / 16;     // 16-row mma tiles a warp owns
  constexpr int kNT = WN / 8;      // 8-column mma tiles a warp owns
  constexpr int kElems = kVec ? 2 : 1;
  constexpr int kALoads = BM * kBK / kElems / kThreads;
  constexpr int kBLoads = kBK * BN / kElems / kThreads;
  constexpr int kSteps = kBK / 4;  // mma steps a slice
  static_assert(kSA % 16 == 4 && kSB % 16 == 4, "staged rows must start 4 doubles past a multiple of 16");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && kBK % 4 == 0, "warp tiles are whole mma tiles");
  static_assert(BM * kBK % (kElems * kThreads) == 0 && kBK * BN % (kElems * kThreads) == 0, "tile loads must split evenly");
  static_assert(kSteps % 2 == 0 && kStages >= 2, "fragment buffers alternate within a slice");

  extern __shared__ __align__(16) double smem[];
  double* const As = smem;                       // [kStages][BM][kSA]
  double* const Bs = smem + kStages * BM * kSA;  // [kStages][kBK][kSB]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / (BN / WN)) * WM;
  const int wn0 = (warp % (BN / WN)) * WN;
  const int tiles_m = (n + BM - 1) / BM;
  const int per_product = tiles_m * ((n + BN - 1) / BN);
  const int slices = (n + kBK - 1) / kBK;

  struct Tile {
    Product p;
    int row0, col0;
  };
  auto tile_at = [&](int index) {
    const int z = index / per_product, rem = index % per_product;
    return Tile{z == 0 ? prods.p[0] : prods.p[1], (rem % tiles_m) * BM, (rem / tiles_m) * BN};
  };

  auto load_stage = [&](const Tile& tl, int stage, int k0) {
    double* as = As + stage * BM * kSA;
    double* bs = Bs + stage * kBK * kSB;
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / (kBK / kElems), kk = (idx % (kBK / kElems)) * kElems;
      const int gr = tl.row0 + r, gk = k0 + kk;
      const bool ok = gr < n && gk < n;
      const double* src = ok ? tl.p.a + static_cast<int64_t>(gr) * n + gk : tl.p.a;
      cp_async<kElems * 8>(as + r * kSA + kk, src, ok);
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / (BN / kElems), cc = (idx % (BN / kElems)) * kElems;
      const int gk = k0 + r, gc = tl.col0 + cc;
      const bool ok = gk < n && gc < n;
      const double* src = ok ? tl.p.b + static_cast<int64_t>(gk) * n + gc : tl.p.b;
      cp_async<kElems * 8>(bs + r * kSB + cc, src, ok);
    }
  };
  // slices 0 .. kStages - 2 of a tile into stages 0 .. kStages - 2
  auto load_first = [&](const Tile& tl) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < slices) load_stage(tl, s, s * kBK);
      cp_async_commit();
    }
  };

  double af[2][kMT][2], bf[2][kNT];
  auto load_frags = [&](int buf, int stage, int kk) {
    const double* as = As + stage * BM * kSA + kk + t;
    const double* bs = Bs + stage * kBK * kSB + (kk + t) * kSB + wn0 + g;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      af[buf][i][0] = as[(wm0 + i * 16 + g) * kSA];
      af[buf][i][1] = as[(wm0 + i * 16 + g + 8) * kSA];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) bf[buf][j] = bs[j * 8];
  };

  const int total = per_product * count;
  if (static_cast<int>(blockIdx.x) >= total) return;
  Tile tile = tile_at(blockIdx.x);
  load_first(tile);
  for (int index = blockIdx.x; index < total; index += gridDim.x) {
    double acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;

    // The ring: slices 0 .. kStages - 2 are in flight; in the last mma step
    // of slice kt, slice kt + kStages - 1 is issued into the stage slice
    // kt - 1 left, then slice kt + 1 is waited for. Fragments are
    // double-buffered in registers: the next step's are loaded from shared
    // memory before this step's mmas issue.
    cp_async_wait<kStages - 2>();  // slice 0 has landed (this thread's copies)
    __syncthreads();               // ... and everyone's
    load_frags(0, 0, 0);
    for (int kt = 0; kt < slices; ++kt) {
#pragma unroll
      for (int step = 0; step < kSteps; ++step) {
        if (step + 1 < kSteps) {
          load_frags((step + 1) & 1, kt % kStages, (step + 1) * 4);
        } else if (kt + 1 < slices) {
          const int next = kt + kStages - 1;
          if (next < slices) load_stage(tile, next % kStages, next * kBK);
          cp_async_commit();
          cp_async_wait<kStages - 2>();  // slice kt + 1 has landed (this thread's copies)
          __syncthreads();               // ... and everyone's
          load_frags(0, (kt + 1) % kStages, 0);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) dmma_16x8x4(acc[i][j], af[step & 1][i], bf[step & 1][j]);
      }
    }

    // every warp is done reading the stages: the next tile's first slices
    // load while this one is stored
    const Tile done = tile;
    __syncthreads();
    if (index + static_cast<int>(gridDim.x) < total) {
      tile = tile_at(index + gridDim.x);
      load_first(tile);
    }

    double scale = 1.0;  // 1 / c, sqrt(c) or both
    if (done.p.scale != kOne) {
      const double c = frobenius(partials, num_partials, lane);
      if (done.p.scale & kDivC) scale /= c;
      if (done.p.scale & kMulSqrtC) scale *= sqrt(c);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8: columns cc and cc + 1 each
          const int r = done.row0 + wm0 + i * 16 + g + h * 8;
          const int cc = done.col0 + wn0 + j * 8 + 2 * t;
          if (r >= n || cc >= n) continue;
          double v0 = acc[i][j][2 * h] * scale, v1 = acc[i][j][2 * h + 1] * scale;
          if (done.p.epilogue == kT) {
            v0 = 0.5 * ((r == cc ? 3.0 : 0.0) - v0);
            v1 = 0.5 * ((r == cc + 1 ? 3.0 : 0.0) - v1);
          }
          double* dst = done.p.c + static_cast<int64_t>(r) * n + cc;
          if (kVec) {  // n even, so cc + 1 < n
            *reinterpret_cast<double2*>(dst) = make_double2(v0, v1);
          } else {
            dst[0] = v0;
            if (cc + 1 < n) dst[1] = v1;
          }
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int kStages, int kBK, bool kVec>
cudaError_t launch_dgemm_as(const Products& prods, int count, const double* partials, int num_partials, int n,
                            int device, cudaStream_t s) {
  constexpr int kSmem = gemm_smem_bytes<BM, BN, kStages, kBK>();
  constexpr int kThreads = (BM / WM) * (BN / WN) * 32;
  auto kernel = ns_dgemm<BM, BN, WM, WN, kStages, kBK, kVec>;
  // blocks resident on the whole card, found once per device and instance
  // (after raising the kernel's shared-memory cap there)
  static int resident_blocks[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident_blocks[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    resident_blocks[device] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const int64_t total = static_cast<int64_t>((n + BM - 1) / BM) * ((n + BN - 1) / BN) * count;
  const int64_t resident = resident_blocks[device];
  const unsigned grid = static_cast<unsigned>(total < resident ? total : resident);
  kernel<<<grid, kThreads, kSmem, s>>>(prods, count, partials, num_partials, n);
  return cudaGetLastError();
}

// BM x BN tiles of WM x WN warp tiles, a ring of kStages slices kBK deep
template <int BM, int BN, int WM, int WN, int kStages, int kBK>
cudaError_t launch_dgemm(const Products& prods, int count, const double* partials, int num_partials, int n, bool vec,
                         int device, cudaStream_t s) {
  auto body = vec ? launch_dgemm_as<BM, BN, WM, WN, kStages, kBK, true>
                  : launch_dgemm_as<BM, BN, WM, WN, kStages, kBK, false>;
  return body(prods, count, partials, num_partials, n, device, s);
}

}  // namespace

extern "C" int tm_fid_sqrtm_max_partials() { return kMaxPartials; }

// a: float64 (n, n) symmetric PSD, row-major; out: float64 (n, n); ws:
// float64 workspace of 4 n^2 + kMaxPartials; all contiguous on the current
// device. Runs `iters` coupled Newton-Schulz steps in 1 + 2 * iters launches
// on `stream` and returns the first failing launch's cudaError_t (0 on
// success).
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
  double* w = static_cast<double*>(ws);
  double* t = w;
  double* y_alt = w + nn;
  double* z[2] = {w + 2 * nn, w + 3 * nn};
  double* partials = w + 4 * nn;
  double* y_out = static_cast<double*>(out);
  const double* src = static_cast<const double*>(a);

  int64_t blocks = (nn + kPrologueThreads * 4 - 1) / (kPrologueThreads * 4);
  const int64_t cap = 2 * static_cast<int64_t>(sms) < kMaxPartials ? 2 * static_cast<int64_t>(sms) : kMaxPartials;
  if (blocks > cap) blocks = cap;
  const int num_partials = static_cast<int>(blocks);
  const int ni = static_cast<int>(n);
  ns_prologue<<<static_cast<unsigned>(blocks), kPrologueThreads, 0, s>>>(src, partials, ni);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // 128 x 128 tiles where they fill the card, 64 x 64 below; 16-byte copies
  // where every row of every operand starts 16-byte aligned
  const int64_t big_tiles = ((n + 127) / 128) * ((n + 127) / 128);
  const bool big = big_tiles >= sms;
  const bool vec = n % 2 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  auto gemm = [&](const Products& p, int count) {
    return big ? launch_dgemm<128, 128, 64, 32, 4, 16>(p, count, partials, num_partials, ni, vec, device, s)
               : launch_dgemm<64, 64, 32, 32, 3, 16>(p, count, partials, num_partials, ni, vec, device, s);
  };

  // Y_k goes to y_out when iters - k is even, else to y_alt, so Y_iters lands
  // in `out` and no product writes the Y it reads; Z_k goes to z[k % 2]
  ns_first_step<<<static_cast<unsigned>(blocks), kPrologueThreads, 0, s>>>(src, t, z[1], partials, num_partials, ni);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  double* y_next = (iters - 1) % 2 == 0 ? y_out : y_alt;
  Products p0{};
  p0.p[0] = {src, t, y_next, kPlain, kDivC | (iters == 1 ? kMulSqrtC : kOne)};  // Y1 = (A / c) T1
  err = gemm(p0, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double* y = y_next;
  for (int k = 2; k <= iters; ++k) {
    const bool last = k == iters;
    const double* zk = z[(k - 1) % 2];
    Products p1{};
    p1.p[0] = {zk, y, t, kT, kOne};
    err = gemm(p1, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    y_next = (iters - k) % 2 == 0 ? y_out : y_alt;
    Products p2{};
    p2.p[0] = {y, t, y_next, kPlain, last ? kMulSqrtC : kOne};
    p2.p[1] = {t, zk, z[k % 2], kPlain, kOne};
    err = gemm(p2, last ? 1 : 2);
    if (err != cudaSuccess) return static_cast<int>(err);
    y = y_next;
  }
  return 0;
}
