// K12 zernike: the 60 float64 sums behind the 30 order-9 Zernike moments
// of each ROI,
//   S[b, 0, k] = sum f R_nm(r) cos_m,   S[b, 1, k] = sum f R_nm(r) sin_m,
// over the pixels of the unit disk eps64 <= r <= 1 around the intensity
// centroid, with f = I / max(s, 1e-30) and k running over the (n, m) with
// n - m even, n <= 9, in JAX's output order.
//
// Replaces nyxus_tpu/ops/zernike.py:38 zernike_features, which builds ten
// cos/sin planes, ten radius powers and 30 radial-polynomial planes of the
// whole bucket and reduces 60 products of them.  Here one pass over the
// pixels does everything in registers: each nonzero pixel's x, y (scaled
// by rad = min(h, w), 1-based as JAX has them), the ok test, cos/sin of
// the angle by the same recurrence (zernike.py:63-68) and R_nm by the same
// Prata recurrence with the H1/H2/H3 tables (:77-95), passed by value as a
// kernel argument.  Every product, sum, quotient and square root is a
// rounded IEEE operation in the input type, formed in JAX's order (no FMA
// contraction), so each term equals the plain version's; the 60 sums
// accumulate in double whatever the input type.  The (n + 1) / pi factors,
// the sign of AI and the magnitudes are left to the caller.
//
// Design: blocks of ROI x chunk, each thread a strip of pixels (a zero
// intensity adds nothing and is skipped); warp shuffles then shared memory
// reduce the block, and one thread a sum writes it (one chunk) or adds it
// with a double atomicAdd into the zeroed output (several chunks).  Bound
// on the card: the ~330 operations of a nonzero pixel.
#include <string.h>

#include "common.cuh"

#define ZK_ORDER 9
#define ZK_TERMS 30
#define ZK_BLOCK 128
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

template <typename T>
__global__ void __launch_bounds__(ZK_BLOCK)
    zernike_kernel(const T* __restrict__ img, const T* __restrict__ cx,
                   const T* __restrict__ cy, const T* __restrict__ rad,
                   const T* __restrict__ sum, const ZTables tb,
                   double* __restrict__ out, int H, int W) {
  __shared__ double red[ZK_BLOCK / 32][2 * ZK_TERMS];
  const int b = blockIdx.x;
  const size_t A = static_cast<size_t>(H) * W;
  const T* ib = img + A * b;
  const T cxb = cx[b];
  const T cyb = cy[b];
  const T rb = rad[b];
  const T sb = fmax(sum[b], static_cast<T>(1e-30));
  double ar[ZK_TERMS], ai[ZK_TERMS];
#pragma unroll
  for (int k = 0; k < ZK_TERMS; ++k) ar[k] = ai[k] = 0.0;
  const size_t stride = static_cast<size_t>(gridDim.y) * blockDim.x;
  for (size_t a = static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x;
       a < A; a += stride) {
    const T v = ib[a];
    if (v == T(0)) continue;
    const T x = z_sub(static_cast<T>(static_cast<int>(a % W) + 1), cxb) / rb;
    const T y = z_sub(static_cast<T>(static_cast<int>(a / W) + 1), cyb) / rb;
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
        ar[k] += static_cast<double>(z_mul(fr, c[m]));
        ai[k] += static_cast<double>(z_mul(fr, sn[m]));
        ++k;
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < ZK_TERMS; ++k) {
    double u = ar[k], w = ai[k];
    for (int off = 16; off > 0; off >>= 1) {
      u += __shfl_down_sync(0xffffffffu, u, off);
      w += __shfl_down_sync(0xffffffffu, w, off);
    }
    if (lane == 0) {
      red[warp][k] = u;
      red[warp][ZK_TERMS + k] = w;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * ZK_TERMS) {
    double u = 0.0;
    for (int k = 0; k < ZK_BLOCK / 32; ++k) u += red[k][threadIdx.x];
    double* o = out + static_cast<size_t>(b) * 2 * ZK_TERMS + threadIdx.x;
    if (gridDim.y == 1)
      *o = u;
    else
      atomicAdd(o, u);
  }
}

// img: [B, H, W]; cx, cy, rad, sum: [B] of the input type; htab: host
// float64 [3, 10, 10] (H1, H2, H3); out: double [B, 2, 30], zeroed by the
// caller when chunks > 1.
extern "C" int nyx_zernike(const void* img, const void* cx, const void* cy,
                           const void* rad, const void* sum, const void* htab,
                           void* out, int B, int H, int W, int chunks,
                           int is_f64, void* stream) {
  ZTables tb;
  memcpy(&tb, htab, sizeof(tb));
  dim3 grid(B, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    zernike_kernel<double><<<grid, ZK_BLOCK, 0, st>>>(
        static_cast<const double*>(img), static_cast<const double*>(cx),
        static_cast<const double*>(cy), static_cast<const double*>(rad),
        static_cast<const double*>(sum), tb, static_cast<double*>(out), H, W);
  else
    zernike_kernel<float><<<grid, ZK_BLOCK, 0, st>>>(
        static_cast<const float*>(img), static_cast<const float*>(cx),
        static_cast<const float*>(cy), static_cast<const float*>(rad),
        static_cast<const float*>(sum), tb, static_cast<double*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
