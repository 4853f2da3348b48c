// K12 zernike: the 30 order-9 Zernike magnitudes of each ROI, and the 60
// float64 sums behind them,
//   S[b, 0, k] = sum f R_nm(r) cos_m,   S[b, 1, k] = sum f R_nm(r) sin_m,
// over the pixels of the unit disk eps64 <= r <= 1 around the intensity
// centroid, with f = I / max(s, 1e-30) and k running over the (n, m) with
// n - m even, n <= 9, in JAX's output order; |A_nm| = sqrt(AR^2 + AI^2),
// AR = (n + 1) / pi * S0, AI = -(n + 1) / pi * S1, and noval for a blank
// ROI (one intensity).
//
// Replaces nyxus_tpu/ops/zernike.py:38 zernike_features, which builds ten
// cos/sin planes, ten radius powers and 30 radial-polynomial planes of the
// whole bucket and reduces 60 products of them.  The centroid, the sum s
// and the radius are read in the kernel from K10's raw sums of the masked
// intensities and the AABB sizes, formed as JAX forms them (zernike.py:
// 46-53): cx = S10 / max(s, 1e-30) + 1 in float64, cast to the input
// type, rad = min(h, w).  One pass over the pixels does everything in
// registers: each nonzero pixel's x, y (1-based, scaled by rad), the ok
// test, cos/sin of the angle by the same recurrence (zernike.py:63-68) and
// R_nm by the same Prata recurrence with the H1/H2/H3 tables (:77-95),
// passed by value as a kernel argument.  Every product, sum, quotient and
// square root is a rounded IEEE operation in the input type, formed in
// JAX's order (no FMA contraction), so each term equals the plain
// version's; the 60 sums accumulate in float64 whatever the input type, and
// the magnitudes are float64 products, a sum and a square root, cast.
//
// Bound on this card: operations, the ~372 of a nonzero pixel inside the
// disk.  Design: a thread-block cluster of C blocks of 256 threads a ROI
// (zernike_plan: as many as the batch can have in one wave, a block an SM,
// at most 8), block r taking pixels [r * chunk, (r + 1) * chunk), a thread
// a pixel in turn, loading its next pixel before it works on the current
// one (a zero intensity adds nothing and is skipped).  The 60 sums stay in
// registers (no spill at 251 a thread; splitting the orders between two
// warps of a pixel ran slower).  A warp reduce-scatter (62
// double shuffles a lane, after which each lane owns two of the 64 padded
// sums) and shared memory give the block's sums, rank 0 adds the
// cluster's through distributed shared memory in rank order and writes
// each output once: no zeroed output, no atomics, no launch around it.
#include <string.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define ZK_ORDER 9
#define ZK_TERMS 30
#define ZK_THREADS 256
#define ZK_SUMS 64  // the 60 padded to a power of two
#define ZK_EPS64 2.220446049250313e-16

struct ZTables {
  double h[3][ZK_ORDER + 1][ZK_ORDER + 1];  // H1, H2, H3
};

__device__ __forceinline__ float z_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double z_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float z_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double z_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float z_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double z_sub(double a, double b) {
  return __dsub_rn(a, b);
}

// img: [B, H, W] masked intensities; raw: K10's float64 raw sums of img,
// ROI b's [4, 4] at b * rs; heights, widths: int32 at b * hs, b * ws; vmin,
// vmax: T at b * vs; mags: T [B, 30]; sums: NULL or double [B, 2, 30].
// Grid B * C blocks, clusters of C, each a ROI's chunk of pixels.
template <typename T>
__global__ void __launch_bounds__(ZK_THREADS)
    zernike_kernel(const T* __restrict__ img, const double* __restrict__ raw,
                   int rs, const int* __restrict__ heights, int hs,
                   const int* __restrict__ widths, int ws,
                   const T* __restrict__ vmin, const T* __restrict__ vmax,
                   int vs, double noval, const ZTables tb,
                   T* __restrict__ mags, double* __restrict__ sums, int H,
                   int W, int C, int chunk) {
  __shared__ double red[ZK_THREADS / 32 * ZK_SUMS];
  __shared__ double part[ZK_SUMS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int b = blockIdx.x / C;
  const int A = H * W;
  const T* ib = img + static_cast<size_t>(A) * b;
  // zernike_inputs: the centroid in float64, + 1, cast; rad = min(h, w);
  // torch.clamp's bound (a NaN sum stays NaN)
  const double* rw = raw + static_cast<size_t>(b) * rs;  // S00, S01, .. S10
  const double s = rw[0];
  const double den = s < 1e-30 ? 1e-30 : s;
  const T cxb = static_cast<T>(__dadd_rn(__ddiv_rn(rw[4], den), 1.0));
  const T cyb = static_cast<T>(__dadd_rn(__ddiv_rn(rw[1], den), 1.0));
  const T rad = static_cast<T>(min(heights[static_cast<size_t>(b) * hs],
                                   widths[static_cast<size_t>(b) * ws]));
  const T st = static_cast<T>(s);
  const T sb = st < static_cast<T>(1e-30) ? static_cast<T>(1e-30) : st;
  double acc[ZK_SUMS];  // AR's 30 sums, AI's 30, 4 zeros
#pragma unroll
  for (int k = 0; k < ZK_SUMS; ++k) acc[k] = 0.0;
  const int a0 = min(A, rank * chunk);
  const int a1 = min(A, a0 + chunk);
  // each thread loads its next pixel before it works on the current one
  int a = a0 + static_cast<int>(threadIdx.x);
  T next = a < a1 ? ib[a] : T(0);
  for (; a < a1; a += ZK_THREADS) {
    const T v = next;
    if (a + ZK_THREADS < a1) next = ib[a + ZK_THREADS];
    if (v == T(0)) continue;
    const T x = z_sub(static_cast<T>(a % W + 1), cxb) / rad;
    const T y = z_sub(static_cast<T>(a / W + 1), cyb) / rad;
    const T r2 = z_add(z_mul(x, x), z_mul(y, y));
    const T r = sqrt(r2);
    if (!(r >= static_cast<T>(ZK_EPS64) && r <= T(1))) continue;
    const T f = v / sb;
    const T inv_r = T(1) / r;
    T c[ZK_ORDER + 1], sn[ZK_ORDER + 1], R[ZK_ORDER + 1];
    c[0] = z_mul(x, inv_r);
    sn[0] = z_mul(y, inv_r);
#pragma unroll
    for (int m = 1; m <= ZK_ORDER; ++m) {
      c[m] = z_sub(z_mul(c[0], c[m - 1]), z_mul(sn[0], sn[m - 1]));
      sn[m] = z_add(z_mul(c[0], sn[m - 1]), z_mul(sn[0], c[m - 1]));
    }
    R[0] = T(1);
#pragma unroll
    for (int n = 1; n <= ZK_ORDER; ++n) R[n] = z_mul(r, R[n - 1]);
    const T inv_r2 = T(1) / r2;
    int k = 0;
#pragma unroll
    for (int n = 0; n <= ZK_ORDER; ++n) {
      T rnm[ZK_ORDER + 1];
      T rp2 = T(0), rp4 = T(0);
#pragma unroll
      for (int m = n; m >= 0; m -= 2) {
        T val;
        if (m == n) {
          val = R[n];
          rp4 = R[n];
        } else if (m == n - 2) {
          val = z_sub(z_mul(static_cast<T>(n), R[n]),
                      z_mul(static_cast<T>(n - 1), R[n >= 2 ? n - 2 : 0]));
          rp2 = val;
        } else {
          const T h1 = static_cast<T>(tb.h[0][n][m]);
          const T h2 = static_cast<T>(tb.h[1][n][m]);
          const T h3 = static_cast<T>(tb.h[2][n][m]);
          val = z_add(z_mul(h1, rp4), z_mul(z_add(h2, z_mul(h3, inv_r2)), rp2));
          rp4 = rp2;
          rp2 = val;
        }
        rnm[m] = val;
      }
#pragma unroll
      for (int m = n % 2; m <= n; m += 2) {
        const T fr = z_mul(f, rnm[m]);
        acc[k] += static_cast<double>(z_mul(fr, c[m]));
        acc[ZK_TERMS + k] += static_cast<double>(z_mul(fr, sn[m]));
        ++k;
      }
    }
  }
  nyx_block_sums<ZK_SUMS>(acc, red, part);
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank == 0 && threadIdx.x < ZK_TERMS) {
    const int t = threadIdx.x;
    double ar = 0.0, ai = 0.0;
    for (int q = 0; q < C; ++q) {
      const double* pq = C > 1 ? cluster.map_shared_rank(part, q) : part;
      ar += pq[t];
      ai += pq[ZK_TERMS + t];
    }
    if (sums) {
      sums[static_cast<size_t>(b) * 2 * ZK_TERMS + t] = ar;
      sums[static_cast<size_t>(b) * 2 * ZK_TERMS + ZK_TERMS + t] = ai;
    }
    // term t's order n: n contributes n / 2 + 1 terms
    int n = 0;
    for (int k = t; k >= n / 2 + 1; ++n) k -= n / 2 + 1;
    const double cst = __ddiv_rn(static_cast<double>(n + 1),
                                 3.141592653589793);
    const double re = __dmul_rn(cst, ar);
    const double im = -__dmul_rn(cst, ai);
    const double mag =
        __dsqrt_rn(__dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im)));
    const size_t vb = static_cast<size_t>(b) * vs;
    mags[static_cast<size_t>(b) * ZK_TERMS + t] =
        vmax[vb] == vmin[vb] ? static_cast<T>(noval) : static_cast<T>(mag);
  }
  if (C > 1) cluster.sync();  // no block leaves while rank 0 reads it
}

template <typename T>
static int zernike_launch(const void* img, const void* raw, int rs,
                          const void* heights, int hs, const void* widths,
                          int ws, const void* vmin, const void* vmax, int vs,
                          double noval, const ZTables& tb, void* mags,
                          void* sums, int B, int H, int W, int C, int chunk,
                          cudaStream_t st) {
  auto kern = zernike_kernel<T>;
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, 0, C, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * C, 1, 1);
  cfg.blockDim = dim3(ZK_THREADS, 1, 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(img),
                         static_cast<const double*>(raw), rs,
                         static_cast<const int*>(heights), hs,
                         static_cast<const int*>(widths), ws,
                         static_cast<const T*>(vmin),
                         static_cast<const T*>(vmax), vs, noval, tb,
                         static_cast<T*>(mags), static_cast<double*>(sums), H,
                         W, C, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The launch of zernike_plan(B, H, W): C blocks a ROI, chunk pixels a
// block.  htab: host float64 [3, 10, 10] (H1, H2, H3); sums may be NULL.
extern "C" int nyx_zernike(const void* img, const void* raw, int rs,
                           const void* heights, int hs, const void* widths,
                           int ws, const void* vmin, const void* vmax, int vs,
                           double noval, const void* htab, void* mags,
                           void* sums, int B, int H, int W, int C, int chunk,
                           int is_f64, void* stream) {
  ZTables tb;
  memcpy(&tb, htab, sizeof(tb));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return zernike_launch<double>(img, raw, rs, heights, hs, widths, ws, vmin,
                                  vmax, vs, noval, tb, mags, sums, B, H, W, C,
                                  chunk, st);
  return zernike_launch<float>(img, raw, rs, heights, hs, widths, ws, vmin,
                               vmax, vs, noval, tb, mags, sums, B, H, W, C,
                               chunk, st);
}
