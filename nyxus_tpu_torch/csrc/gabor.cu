// K11 gabor: the Gabor family's magnitudes, per-ROI statistics and
// threshold counts over each ROI's AABB.
//
// Replaces nyxus_tpu/ops/gabor.py:49 _gabor_magnitude (a 2-channel lax conv
// of the whole padded bucket per filter, five of them) and the statistics
// of :69 gabor_features.  For an output pixel (y, x), JAX's full
// convolution cropped at off = ceil(n / 2) is
//   C(y, x) = sum_{i, j < n} K[i][j] * A[y + off - i][x + off - j],
// with A zero outside the bucket (masked intensities are zero off the ROI
// anyway); the magnitude is floor(sqrt(re^2 + im^2)), the reference's
// PixIntens truncation.  Only AABB pixels enter a statistic, so only they
// are convolved.
//
// Two passes over 16 x 16 output tiles of every ROI, one thread a pixel:
//   pass 1, the baseline filter (taps 0): writes its magnitudes into a
//     [B, H, W] plane at the AABB pixels and folds them into the ROI's max
//     and min (atomics on the bit patterns of non-negative values);
//   pass 2: counts the baseline pixels above the min, then convolves the
//     other filters four at a time and counts mag / max(maxval, 1e-30) >
//     thold, the division and comparison JAX makes (warp ballots, one
//     atomic per warp).
// A block stages its input tile with its n - 1 halo and the pass's taps in
// shared memory; either one reads device memory instead when it does not
// fit a block (large kersize), so any n works.  The taps are added in a
// fixed order (row i outer, column j inner) with every product and sum
// rounded on its own (no FMA contraction), as the plain version adds them:
// the two agree bit for bit, so the floors, and every count, are equal in
// both types.  Bound on the card: operations, 4 n^2 multiplies and adds a
// filter and AABB pixel (reads of the shared tile and the broadcast taps,
// and the unfused multiply-adds, keep it well below the CUDA cores' rate).
#include <math.h>

#include "common.cuh"

#define GABOR_TILE 16
#define GABOR_GROUP 4
#define GABOR_SMEM_MAX 232448

__device__ __forceinline__ float g_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double g_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float g_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double g_add(double a, double b) {
  return __dadd_rn(a, b);
}

// Non-negative IEEE values order like their bit patterns read as signed
// integers; -inf (a negative pattern) and +inf are the identities.
__device__ __forceinline__ void atomic_max_nonneg(float* a, float v) {
  atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
}
__device__ __forceinline__ void atomic_max_nonneg(double* a, double v) {
  atomicMax(reinterpret_cast<long long*>(a), __double_as_longlong(v));
}
__device__ __forceinline__ void atomic_min_nonneg(float* a, float v) {
  atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
}
__device__ __forceinline__ void atomic_min_nonneg(double* a, double v) {
  atomicMin(reinterpret_cast<long long*>(a), __double_as_longlong(v));
}

// The input window of one output tile: the shared tile when staged, else
// the ROI's crop in device memory with zeros outside the bucket.
template <typename T>
struct TileIn {
  const T* tile;
  const T* img;
  int tw, iy0, ix0, H, W;
  __device__ __forceinline__ T operator()(int ty, int tx) const {
    if (tile) return tile[ty * tw + tx];
    const int gy = iy0 + ty;
    const int gx = ix0 + tx;
    return (gy >= 0 && gy < H && gx >= 0 && gx < W)
               ? img[static_cast<size_t>(gy) * W + gx]
               : T(0);
  }
};

// Magnitudes of filters f < nf (taps [nf, 2, n, n]) at the tile-local
// output pixel (ly, lx).
template <typename T, int G>
__device__ __forceinline__ void convolve(const TileIn<T>& in,
                                         const T* taps, int n, int nf,
                                         int ly, int lx, T* mag) {
  T re[G], im[G];
#pragma unroll
  for (int f = 0; f < G; ++f) re[f] = im[f] = T(0);
  const int nn = n * n;
  for (int i = 0; i < n; ++i) {
    const int ty = ly + n - 1 - i;
    for (int j = 0; j < n; ++j) {
      const T a = in(ty, lx + n - 1 - j);
      const T* t = taps + i * n + j;
#pragma unroll
      for (int f = 0; f < G; ++f) {
        if (f < nf) {
          re[f] = g_add(re[f], g_mul(a, t[2 * f * nn]));
          im[f] = g_add(im[f], g_mul(a, t[(2 * f + 1) * nn]));
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < G; ++f)
    if (f < nf) mag[f] = floor(sqrt(g_add(g_mul(re[f], re[f]),
                                          g_mul(im[f], im[f]))));
}

// Stages the block's taps and input tile (where they fit) and returns the
// window; *tp is set to the taps to read.
template <typename T>
__device__ TileIn<T> stage(T* sm, const T* img_b, const T* taps,
                           int ntaps, int H, int W, int n, int ty0, int tx0,
                           int use_tile, int use_taps, const T** tp) {
  const int tw = GABOR_TILE + n - 1;
  const int off = (n + 1) / 2;
  TileIn<T> in{nullptr, img_b, tw, ty0 + off - (n - 1), tx0 + off - (n - 1),
               H, W};
  T* taps_s = sm + (use_tile ? tw * tw : 0);
  *tp = taps;
  if (use_taps) {
    for (int k = threadIdx.x; k < ntaps; k += blockDim.x) taps_s[k] = taps[k];
    *tp = taps_s;
  }
  if (use_tile) {
    for (int k = threadIdx.x; k < tw * tw; k += blockDim.x)
      sm[k] = in(k / tw, k % tw);
    in.tile = sm;
  }
  __syncthreads();
  return in;
}

template <typename T>
__global__ void gabor_base_kernel(const T* __restrict__ img,
                                  const T* __restrict__ taps,
                                  const int* __restrict__ heights,
                                  const int* __restrict__ widths,
                                  T* __restrict__ base, T* maxval, T* cmpval,
                                  int H, int W, int n, int tiles_x, int tiles,
                                  int use_tile, int use_taps) {
  extern __shared__ double smem_d[];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  const int ty0 = (t / tiles_x) * GABOR_TILE;
  const int tx0 = (t % tiles_x) * GABOR_TILE;
  if (ty0 >= h || tx0 >= w) return;  // the whole block: no barrier missed
  const size_t plane = static_cast<size_t>(H) * W;
  const T* tp;
  const TileIn<T> in = stage(reinterpret_cast<T*>(smem_d), img + plane * b,
                             taps, 2 * n * n, H, W, n, ty0, tx0, use_tile,
                             use_taps, &tp);
  const int ly = threadIdx.x / GABOR_TILE;
  const int lx = threadIdx.x % GABOR_TILE;
  const int y = ty0 + ly;
  const int x = tx0 + lx;
  T mx = -static_cast<T>(INFINITY);
  T mn = static_cast<T>(INFINITY);
  if (y < h && x < w) {
    T mag;
    convolve<T, 1>(in, tp, n, 1, ly, lx, &mag);
    base[plane * b + static_cast<size_t>(y) * W + x] = mag;
    mx = mn = mag;
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  if ((threadIdx.x & 31) == 0 && mx >= T(0)) {
    atomic_max_nonneg(maxval + b, mx);
    atomic_min_nonneg(cmpval + b, mn);
  }
}

template <typename T>
__global__ void gabor_count_kernel(const T* __restrict__ img,
                                   const T* __restrict__ taps,
                                   const int* __restrict__ heights,
                                   const int* __restrict__ widths,
                                   const T* __restrict__ base,
                                   const T* __restrict__ maxval,
                                   const T* __restrict__ cmpval,
                                   int* __restrict__ counts, int H, int W,
                                   int n, int K, T thold, int tiles_x,
                                   int tiles, int use_tile, int use_taps) {
  extern __shared__ double smem_d[];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  const int ty0 = (t / tiles_x) * GABOR_TILE;
  const int tx0 = (t % tiles_x) * GABOR_TILE;
  if (ty0 >= h || tx0 >= w) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const int nn2 = 2 * n * n;
  const T* tp;
  const TileIn<T> in = stage(reinterpret_cast<T*>(smem_d), img + plane * b,
                             taps + nn2, (K - 1) * nn2, H, W, n, ty0, tx0,
                             use_tile, use_taps, &tp);
  const int ly = threadIdx.x / GABOR_TILE;
  const int lx = threadIdx.x % GABOR_TILE;
  const int y = ty0 + ly;
  const int x = tx0 + lx;
  const bool valid = y < h && x < w;
  const bool lane0 = (threadIdx.x & 31) == 0;
  int* cb = counts + static_cast<size_t>(b) * K;
  unsigned bal = __ballot_sync(
      0xffffffffu,
      valid && base[plane * b + static_cast<size_t>(y) * W + x] > cmpval[b]);
  if (lane0 && bal) atomicAdd(cb, __popc(bal));
  const T denom = fmax(maxval[b], static_cast<T>(1e-30));
  for (int g0 = 1; g0 < K; g0 += GABOR_GROUP) {
    const int nf = min(GABOR_GROUP, K - g0);
    T mag[GABOR_GROUP];
    if (valid)
      convolve<T, GABOR_GROUP>(in, tp + (g0 - 1) * nn2, n, nf, ly, lx, mag);
#pragma unroll
    for (int f = 0; f < GABOR_GROUP; ++f) {
      if (f < nf) {  // uniform over the block
        bal = __ballot_sync(0xffffffffu, valid && mag[f] / denom > thold);
        if (lane0 && bal) atomicAdd(cb + g0 + f, __popc(bal));
      }
    }
  }
}

template <typename T>
static int gabor_launch(const void* img, const void* taps,
                        const void* heights, const void* widths, void* base,
                        void* maxval, void* cmpval, void* counts, int B,
                        int H, int W, int n, int K, double thold,
                        cudaStream_t st) {
  const int tiles_x = (W + GABOR_TILE - 1) / GABOR_TILE;
  const int tiles_y = (H + GABOR_TILE - 1) / GABOR_TILE;
  const long long nblocks = static_cast<long long>(B) * tiles_x * tiles_y;
  if (nblocks > 0x7fffffffLL || n < 1 || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = tiles_x * tiles_y;
  const size_t tw = GABOR_TILE + n - 1;
  const size_t tile_b = tw * tw * sizeof(T);
  const int use_tile = tile_b <= GABOR_SMEM_MAX;
  const size_t fixed = use_tile ? tile_b : 0;
  const size_t nn2 = 2 * static_cast<size_t>(n) * n;
  // pass 1: the baseline filter's taps
  const size_t taps1 = nn2 * sizeof(T);
  const int use_taps1 = fixed + taps1 <= GABOR_SMEM_MAX;
  const size_t smem1 = fixed + (use_taps1 ? taps1 : 0);
  cudaError_t e = nyx_allow_smem(gabor_base_kernel<T>, smem1);
  if (e != cudaSuccess) return static_cast<int>(e);
  gabor_base_kernel<T><<<static_cast<int>(nblocks), GABOR_TILE * GABOR_TILE,
                         smem1, st>>>(
      static_cast<const T*>(img), static_cast<const T*>(taps),
      static_cast<const int*>(heights), static_cast<const int*>(widths),
      static_cast<T*>(base), static_cast<T*>(maxval),
      static_cast<T*>(cmpval), H, W, n, tiles_x, tiles, use_tile, use_taps1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // pass 2: the other K - 1 filters' taps
  const size_t taps2 = (K - 1) * nn2 * sizeof(T);
  const int use_taps2 = fixed + taps2 <= GABOR_SMEM_MAX;
  const size_t smem2 = fixed + (use_taps2 ? taps2 : 0);
  e = nyx_allow_smem(gabor_count_kernel<T>, smem2);
  if (e != cudaSuccess) return static_cast<int>(e);
  gabor_count_kernel<T><<<static_cast<int>(nblocks),
                          GABOR_TILE * GABOR_TILE, smem2, st>>>(
      static_cast<const T*>(img), static_cast<const T*>(taps),
      static_cast<const int*>(heights), static_cast<const int*>(widths),
      static_cast<const T*>(base), static_cast<const T*>(maxval),
      static_cast<const T*>(cmpval), static_cast<int*>(counts), H, W, n, K,
      static_cast<T>(thold), tiles_x, tiles, use_tile, use_taps2);
  return static_cast<int>(cudaGetLastError());
}

// img: [B, H, W] masked intensities; taps: [K, 2, n, n] of the same type
// (the baseline filter first); heights, widths: int32 [B]; base: [B, H, W]
// scratch; maxval / cmpval: [B], preset to -inf / +inf; counts: int32
// [B, K], zeroed.
extern "C" int nyx_gabor(const void* img, const void* taps,
                         const void* heights, const void* widths, void* base,
                         void* maxval, void* cmpval, void* counts, int B,
                         int H, int W, int n, int K, double thold, int is_f64,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return gabor_launch<double>(img, taps, heights, widths, base, maxval,
                                cmpval, counts, B, H, W, n, K, thold, st);
  return gabor_launch<float>(img, taps, heights, widths, base, maxval, cmpval,
                             counts, B, H, W, n, K, thold, st);
}
