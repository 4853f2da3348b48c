// K10 power_sums: the 16 weighted coordinate power sums
//   S[b, p, i, j] = sum over pixels of w_p * (x - ox)^i * (y - oy)^j,
//   i, j = 0..3,
// of one or two [B, H, W] weight planes, in AABB-local coordinates (x the
// column, y the row), around an optional per-(ROI, plane) centre (ox, oy).
//
// Replaces nyxus_tpu/ops/moments.py:36 _power_sums (16 products and
// reductions over the crop, called four times per moment family: raw and
// central sums of the plain and the contour-weighted plane) and the
// coordinate sums of nyxus_tpu/ops/morphology.py:32-52,94-104 (centroid,
// weighted centroid, the ellipse's centred second moments).  Each term is
// formed as JAX forms it, in the input type with powers by multiplication:
// x^3 = (x * x) * x, term = (w * x^i) * y^j, rounded products (no FMA).
// Central moments come from a second launch with the centre, as JAX takes
// them (moments.py:75-77, :107-109): a binomial expansion of the raw sums
// would cancel catastrophically in float32.
//
// Design: blocks of (ROI, plane) x chunk; each thread walks a strip of
// pixels, skips zero weights (a zero term adds nothing) and accumulates
// the 16 sums in double whatever the input type; warp shuffles then shared
// memory reduce the block, and one thread a sum writes it (one chunk) or
// adds it with a double atomicAdd into the zeroed output (several chunks,
// for large buckets).  The output is double; the wrapper casts it to the
// compute type.  Bound on the card: bytes (each weight read once) at large
// buckets; at the main path's 32 x 32 crops, the 30-odd multiplies and
// adds of a nonzero pixel.
#include "common.cuh"

__device__ __forceinline__ float nyx_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double nyx_mul(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__global__ void power_sums_kernel(const T* __restrict__ w0,
                                  const T* __restrict__ w1,
                                  const T* __restrict__ centre,
                                  double* __restrict__ out, int P, int H,
                                  int W) {
  __shared__ double red[NYX_BLOCK / 32][16];
  const int bp = blockIdx.x;  // b * P + p
  const int p = bp % P;
  const size_t A = static_cast<size_t>(H) * W;
  const T* wb = (p == 0 ? w0 : w1) + (bp / P) * A;
  const T ox = centre ? centre[2 * bp] : T(0);
  const T oy = centre ? centre[2 * bp + 1] : T(0);
  double acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0;
  const size_t stride = static_cast<size_t>(gridDim.y) * blockDim.x;
  for (size_t a = static_cast<size_t>(blockIdx.y) * blockDim.x + threadIdx.x;
       a < A; a += stride) {
    const T wv = wb[a];
    if (wv == T(0)) continue;
    const T x = static_cast<T>(static_cast<int>(a % W)) - ox;
    const T y = static_cast<T>(static_cast<int>(a / W)) - oy;
    const T xx = nyx_mul(x, x);
    const T yy = nyx_mul(y, y);
    const T xp[4] = {T(1), x, xx, nyx_mul(xx, x)};
    const T yq[4] = {T(1), y, yy, nyx_mul(yy, y)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const T wx = nyx_mul(wv, xp[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i * 4 + j] += static_cast<double>(nyx_mul(wx, yq[j]));
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    double v = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    double v = 0.0;
    for (int k = 0; k < NYX_BLOCK / 32; ++k) v += red[k][threadIdx.x];
    double* o = out + static_cast<size_t>(bp) * 16 + threadIdx.x;
    if (gridDim.y == 1)
      *o = v;
    else
      atomicAdd(o, v);
  }
}

// w1: NULL when P == 1; centre: NULL, or [B, P, 2] (ox, oy) of the input
// type; out: double [B, P, 4, 4], zeroed by the caller when chunks > 1.
extern "C" int nyx_power_sums(const void* w0, const void* w1,
                              const void* centre, void* out, int B, int P,
                              int H, int W, int chunks, int is_f64,
                              void* stream) {
  dim3 grid(B * P, chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    power_sums_kernel<double><<<grid, NYX_BLOCK, 0, st>>>(
        static_cast<const double*>(w0), static_cast<const double*>(w1),
        static_cast<const double*>(centre), static_cast<double*>(out), P, H,
        W);
  else
    power_sums_kernel<float><<<grid, NYX_BLOCK, 0, st>>>(
        static_cast<const float*>(w0), static_cast<const float*>(w1),
        static_cast<const float*>(centre), static_cast<double*>(out), P, H,
        W);
  return static_cast<int>(cudaGetLastError());
}
