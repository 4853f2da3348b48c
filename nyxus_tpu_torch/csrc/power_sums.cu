// K10 power_sums: every weighted coordinate power sum the moment,
// morphology, ellipse and Zernike families read, in one launch a call:
//   S[b, p, i, j] = sum over pixels of w_p * (x - ox)^i * (y - oy)^j,
//   i, j = 0..3,
// in AABB-local coordinates (x the column, y the row), of four weight
// planes formed from the crop, its mask and its contour log-weights:
//   p = 0  the mask as 0/1                     (Smoms, morphology, ellipse)
//   p = 1  the masked intensity                (Imoms, morphology, Zernike)
//   p = 2  the masked intensity * logw         (Imoms W*)
//   p = 3  the mask * logw                     (Smoms W*)
// (p = 0, 1 alone when no family reads logw).  Each plane's raw sums
// (centre 0), its sums around its own centroid (S10 / S00, S01 / S00, 0
// where S00 is 0) and, for the mask, its sums around the ellipse's centroid
// (S10 / area, S01 / area), with the centres themselves.
//
// Replaces nyxus_tpu/ops/moments.py:36 _power_sums, as :49 moments_all
// calls it (raw sums, then central sums around the safe_div centroid, of
// the plain and the contour-weighted plane), the coordinate sums of
// nyxus_tpu/ops/morphology.py (centroid, weighted centroid, the ellipse's
// centred second moments) and the intensity sums behind the centroid of
// nyxus_tpu/ops/zernike.py:38.  Each term is formed as JAX forms it, in
// the input type with powers by multiplication: x^3 = (x * x) * x, term =
// (w * x^i) * y^j, w * logw a rounded product, every product rounded (no
// FMA); the centres in the input type from the float64 sums cast to it,
// with IEEE quotients; central sums from a second pass around them (a
// binomial expansion of the raw sums would cancel catastrophically in
// float32).  Sums accumulate in float64 whatever the input type.
//
// Bound on this card: bytes at large buckets (the crop, its mask and its
// log-weights each read once); at the main path's 32 x 32 crops the 40-odd
// operations of a nonzero weight and pass.  Design: a thread-block cluster
// of C blocks a (ROI, plane, centre), C = 1 at the main buckets
// (power_sums_plan), P + 1 of them a ROI: one a plane around its own
// centre, and one more for the mask around the ellipse's (one block with
// both centres held 32 sums a thread and set the launch's time).  Block r
// of a cluster takes pixels [r * chunk, (r + 1) * chunk).  Pass one forms
// the plane from the inputs, each thread loading its next pixel's before
// it works on the current one and never waiting on the mask to load the
// intensity, stages the plane in shared memory (where the plan gives it
// room; else pass two forms it again) and adds the raw terms of its
// nonzero weights; a warp reduce-scatter and shared memory give the
// block's 16 sums, the cluster adds its blocks' through distributed shared
// memory in rank order, and every block finds its centre itself.  Pass two
// reads the staged plane for the centred terms.  Rank 0 writes each output
// once: no zeroed output, no atomics, no second launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define PS_THREADS 256
// the kernel's static shared memory: the warps' sums, two parts, the totals
#define PS_STATIC_BYTES (8 * (PS_THREADS / 32 * 16 + 2 * 16 + 4))

__device__ __forceinline__ float ps_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double ps_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float ps_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double ps_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float ps_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double ps_div(double a, double b) {
  return __ddiv_rn(a, b);
}

// v where m, else +0, as torch.where(mask, v, 0) gives it: a bitwise and,
// so that the load of v does not wait on the mask's
__device__ __forceinline__ float ps_keep(float v, bool m) {
  return __int_as_float(__float_as_int(v) & -static_cast<int>(m));
}
__device__ __forceinline__ double ps_keep(double v, bool m) {
  return __longlong_as_double(__double_as_longlong(v) &
                              -static_cast<long long>(m));
}

// plane p's weight at pixel a, as the families form it: mask.to(dt),
// where(mask, intens, 0), and those times logw; the loads a plane needs are
// issued together
template <typename T>
__device__ __forceinline__ T ps_weight(int p, const T* in,
                                       const unsigned char* mk, const T* lw,
                                       int a) {
  const bool m = mk[a] != 0;
  const T w = p == 1 || p == 2 ? ps_keep(in[a], m) : (m ? T(1) : T(0));
  return p < 2 ? w : ps_mul(w, lw[a]);
}

// the 16 terms of one weight around one centre, added to acc
template <typename T>
__device__ __forceinline__ void ps_terms(double* acc, T w, T x, T y) {
  const T xx = ps_mul(x, x);
  const T yy = ps_mul(y, y);
  const T xp[4] = {T(1), x, xx, ps_mul(xx, x)};
  const T yq[4] = {T(1), y, yy, ps_mul(yy, y)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T wx = ps_mul(w, xp[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i * 4 + j] += static_cast<double>(ps_mul(wx, yq[j]));
  }
}

// one pass over the block's pixels [a0, a1): acc = the 16 sums of the
// terms of plane p's nonzero weights around (ox, oy), the weights read
// from vals (from_vals), else formed from the inputs, each thread loading
// its next pixel's before it works on the current one (and writing them to
// vals where it is given)
template <typename T>
__device__ __forceinline__ void ps_pass(double* acc, int p, const T* in,
                                        const unsigned char* mk, const T* lw,
                                        T* vals, bool from_vals, int a0,
                                        int a1, int W, T ox, T oy) {
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0;
  const int step = static_cast<int>(blockDim.x);
  int a = a0 + static_cast<int>(threadIdx.x);
  T next = T(0);
  if (!from_vals && a < a1) next = ps_weight(p, in, mk, lw, a);
  for (; a < a1; a += step) {
    T w;
    if (from_vals) {
      w = vals[a - a0];
    } else {
      w = next;
      if (a + step < a1) next = ps_weight(p, in, mk, lw, a + step);
      if (vals) vals[a - a0] = w;
    }
    if (w == T(0)) continue;  // a zero weight's terms add nothing
    ps_terms(acc, w, ps_sub(static_cast<T>(a % W), ox),
             ps_sub(static_cast<T>(a / W), oy));
  }
}

__device__ __forceinline__ void ps_sync(cg::cluster_group& cluster, int C) {
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
}

// a cluster-wide total: sum k of every block's part, in rank order
__device__ __forceinline__ double ps_total(cg::cluster_group& cluster,
                                           double* part, int k, int C) {
  if (C == 1) return part[k];
  double s = 0.0;
  for (int r = 0; r < C; ++r) s += cluster.map_shared_rank(part, r)[k];
  return s;
}

// intens, logw: [B, H, W] of T (logw NULL when P == 2); mask: [B, H, W]
// bytes; area: int32 at b * as; sums: double [B, 2P + 1, 16] (raw sums of
// plane p at row p, centred at P + p, the ellipse's at 2P); centres: T
// [B, P + 1, 2] (plane p's at p, the ellipse's at P).  Grid B * (P + 1) * C
// blocks, clusters of C: block q < P of a ROI sums plane q around 0 and
// its own centre, block P the mask around 0 and the ellipse's centre.
template <typename T>
__global__ void __launch_bounds__(PS_THREADS)
    power_sums_kernel(const T* __restrict__ intens,
                      const unsigned char* __restrict__ mask,
                      const T* __restrict__ logw,
                      const int* __restrict__ area, int as,
                      double* __restrict__ sums, T* __restrict__ centres,
                      int P, int H, int W, int C, int chunk, int staged) {
  extern __shared__ __align__(16) unsigned char ps_smem[];
  __shared__ double red[PS_THREADS / 32 * 16];
  __shared__ double part[2][16];
  __shared__ double tot[4];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int bq = blockIdx.x / C;
  const int b = bq / (P + 1);
  const int q = bq % (P + 1);
  const int p = q < P ? q : 0;  // the ellipse's block sums the mask
  const int A = H * W;
  const size_t off = static_cast<size_t>(b) * A;
  const T* in = intens + off;
  const unsigned char* mk = mask + off;
  const T* lw = logw ? logw + off : nullptr;
  T* vals = staged ? reinterpret_cast<T*>(ps_smem) : nullptr;
  const int a0 = min(A, rank * chunk);
  const int a1 = min(A, a0 + chunk);
  double* out = sums + static_cast<size_t>(b) * (2 * P + 1) * 16;
  double acc[16];

  // pass one: the raw sums, staging the plane
  ps_pass(acc, p, in, mk, lw, vals, false, a0, a1, W, T(0), T(0));
  nyx_block_sums<16>(acc, red, part[0]);
  ps_sync(cluster, C);
  if (threadIdx.x < 16) {
    const double s = ps_total(cluster, part[0], threadIdx.x, C);
    if (rank == 0 && q < P) out[p * 16 + threadIdx.x] = s;
    // S00, S01 and S10, which the centre reads
    if (threadIdx.x == 0) tot[0] = s;
    if (threadIdx.x == 1) tot[1] = s;
    if (threadIdx.x == 4) tot[2] = s;
  }
  __syncthreads();
  // the centre in the input type: the sums cast to it, then safe_div (0
  // where S00 is 0) for a plane's own, S / area for the ellipse's
  const T m00 = static_cast<T>(tot[0]);
  const T s01 = static_cast<T>(tot[1]);
  const T s10 = static_cast<T>(tot[2]);
  T ox, oy;
  if (q < P) {
    ox = m00 != T(0) ? ps_div(s10, m00) : T(0);
    oy = m00 != T(0) ? ps_div(s01, m00) : T(0);
  } else {
    const T n = static_cast<T>(area[static_cast<size_t>(b) * as]);
    ox = ps_div(s10, n);
    oy = ps_div(s01, n);
  }
  if (rank == 0 && threadIdx.x == 0) {
    T* cb = centres + (static_cast<size_t>(b) * (P + 1) + q) * 2;
    cb[0] = ox;
    cb[1] = oy;
  }
  // pass two: the centred sums, at row P + q
  ps_pass(acc, p, in, mk, lw, vals, vals != nullptr, a0, a1, W, ox, oy);
  nyx_block_sums<16>(acc, red, part[1]);
  ps_sync(cluster, C);
  if (rank == 0 && threadIdx.x < 16)
    out[(P + q) * 16 + threadIdx.x] = ps_total(cluster, part[1], threadIdx.x,
                                               C);
  if (C > 1) cluster.sync();  // no block leaves while rank 0 reads it
}

template <typename T>
static int power_sums_launch(const void* intens, const void* mask,
                             const void* logw, const void* area, int as,
                             void* sums, void* centres, int B, int P, int H,
                             int W, int C, int chunk, int threads, int smem,
                             cudaStream_t st) {
  auto kern = power_sums_kernel<T>;
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, static_cast<size_t>(smem), C, &done,
                                    PS_STATIC_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * (P + 1) * C, 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned int>(threads), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(intens),
                         static_cast<const unsigned char*>(mask),
                         static_cast<const T*>(logw),
                         static_cast<const int*>(area), as,
                         static_cast<double*>(sums), static_cast<T*>(centres),
                         P, H, W, C, chunk, smem > 0 ? 1 : 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The launch of power_sums_plan(B, H, W, esz, P): C blocks a (ROI, plane),
// chunk pixels a block, threads a block, smem bytes of staged plane (0:
// pass two forms the plane again from the inputs).
extern "C" int nyx_power_sums(const void* intens, const void* mask,
                              const void* logw, const void* area, int as,
                              void* sums, void* centres, int B, int P, int H,
                              int W, int C, int chunk, int threads, int smem,
                              int is_f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return power_sums_launch<double>(intens, mask, logw, area, as, sums,
                                     centres, B, P, H, W, C, chunk, threads,
                                     smem, st);
  return power_sums_launch<float>(intens, mask, logw, area, as, sums, centres,
                                  B, P, H, W, C, chunk, threads, smem, st);
}
