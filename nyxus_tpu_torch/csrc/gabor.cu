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
// Two designs, chosen by the wrapper's plan (ops/gabor.py gabor_plan):
//
// The cluster path, one launch: one thread-block cluster of C <= 16 blocks
// of 256 threads per ROI.  The ROI's AABB output pixels are cut into strips
// of P (1 or 2) pixels along x, numbered row by row over the AABB's actual
// width, and the K filters into G groups of KG; an item is a (strip,
// group), and the ROI's items are split evenly over the cluster's blocks,
// one a thread (so only real AABB pixels are convolved).  A block copies
// the taps, interleaved as [tap][filter, re/im] by the wrapper, and the
// input window of its rows (zero outside the bucket) into shared memory
// with asynchronous copies, and marks the window rows that hold a non-zero.
// Each thread computes its KG filters' magnitudes at its P pixels in one
// pass, sliding the input row through registers (one shared load a tap,
// the tap pairs read as broadcast vectors), skipping the tap rows whose
// window row is zero for the whole warp, and keeps them in registers: no
// base plane, the baseline convolved once.  The ROI's baseline max and min
// are reduced in the block, then across the cluster through distributed
// shared memory; each thread then counts its pixels into the block's
// counts, the block adds them into block 0's, and block 0 writes the ROI's
// K counts, max and min once.  No presets, no global atomics, no scratch.
// The plan takes all K filters at two pixels a thread where the batch
// fills the card (the fewest loads and operations a pixel), and fewer
// filters and pixels a thread where it does not (shorter chains).
//
// The tile path, two launches over 16 x 16 output tiles of every ROI, one
// thread a pixel, for AABBs a cluster cannot hold (more than 16 x 256
// items), kernels whose taps and window do not fit a block, or more than
// eight filters:
//   pass 1, the baseline filter (taps 0): writes its magnitudes into a
//     [B, H, W] plane at the AABB pixels and folds them into the ROI's max
//     and min (atomics on the bit patterns of non-negative values);
//   pass 2: counts the baseline pixels above the min, then convolves the
//     other filters four at a time and counts mag / max(maxval, 1e-30) >
//     thold, the division and comparison JAX makes (warp ballots, one
//     atomic per warp).
// A block stages its input tile with its n - 1 halo and the pass's taps in
// shared memory; either one reads device memory instead when it does not
// fit a block (large kersize), so any n works.
//
// Both add the taps in a fixed order (row i outer, column j inner) with
// every product and sum rounded on its own (no FMA contraction), as the
// plain version adds them: they agree bit for bit, so the floors, and
// every count, are equal in both types.  Bound on the card: operations,
// 4 n^2 multiplies and adds a filter and AABB pixel; unfused, each is an
// instruction of its own, so the CUDA cores' floor is twice the time of
// the FMA-counted peak.  The cluster path's register tiling reads a tap
// pair once for all P pixels and one input value a tap, so its shared
// loads stay well below its arithmetic: at 64 x 32^2 its convolution
// issues close to the CUDA cores' rate for the pixels a block holds, and
// the card's other SMs idle (PERF.md).
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define GABOR_TILE 16
#define GABOR_GROUP 4
#define GABOR_SMEM_MAX 232448
#define GABOR_THREADS 256
#define GABOR_CLUSTER_MAX 16
#define GABOR_KMAX 8
#define GABOR_ROWS_MAX 512
#define GABOR_STATIC_SMEM 4096

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
                                  const int* __restrict__ widths, int hs,
                                  int ws, T* __restrict__ base, T* maxval,
                                  T* cmpval, int H, int W, int n, int tiles_x,
                                  int tiles, int use_tile, int use_taps) {
  extern __shared__ double smem_d[];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int h = min(heights[static_cast<size_t>(b) * hs], H);
  const int w = min(widths[static_cast<size_t>(b) * ws], W);
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
                                   const int* __restrict__ widths, int hs,
                                   int ws, const T* __restrict__ base,
                                   const T* __restrict__ maxval,
                                   const T* __restrict__ cmpval,
                                   int* __restrict__ counts, int H, int W,
                                   int n, int K, T thold, int tiles_x,
                                   int tiles, int use_tile, int use_taps) {
  extern __shared__ double smem_d[];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int h = min(heights[static_cast<size_t>(b) * hs], H);
  const int w = min(widths[static_cast<size_t>(b) * ws], W);
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

// ---------------------------------------------------------------------------
// The cluster path

// an asynchronous copy into shared memory (cp.async) of one value of T,
// zero-filled when ``in`` is false (the source not read); 16-byte copies
// are common.cuh's nyx_cp16
template <typename T>
__device__ __forceinline__ void gabor_cp_zfill(T* dst, const T* src,
                                               bool in) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int n = in ? static_cast<int>(sizeof(T)) : 0;
  if (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

// a tap's (re, im) pair of T, read as one vector
template <typename T>
struct GaborPair;
template <>
struct GaborPair<float> {
  using V = float2;
};
template <>
struct GaborPair<double> {
  using V = double2;
};

// counts: int32 [B, K]; maxval, cmpval: [B]; every one written by block 0
// of the ROI's cluster.  taps: [n * n, KP], tap (i, j)'s (re, im) pairs of
// the G * KG filters (zeros past K), KP = 2 G KG rounded up to 16 bytes
// (ops/gabor.py tap_rows).  Item it of the ROI is strip it / G (P pixels
// along x, strips numbered row by row over the AABB's width) and filter
// group it % G (filters [g KG, g KG + KG)); thread t of block r owns item
// r * GABOR_THREADS + t.
template <typename T, int KG, int P>
__global__ void __launch_bounds__(GABOR_THREADS)
    gabor_cluster_kernel(const T* __restrict__ img,
                         const T* __restrict__ taps,
                         const int* __restrict__ heights,
                         const int* __restrict__ widths, int hs, int ws,
                         int* __restrict__ counts, T* __restrict__ maxval,
                         T* __restrict__ cmpval, int H, int W, int n, int K,
                         int G, int C, T thold) {
  using V2 = typename GaborPair<T>::V;
  constexpr int NW = GABOR_THREADS / 32;
  constexpr int VN = 16 / sizeof(T);
  extern __shared__ __align__(16) double gabor_smem[];
  __shared__ T part_max[NW], part_min[NW];
  __shared__ T blk_ext[2];  // this block's max and min, read by the others
  __shared__ T roi_ext[2];  // the ROI's
  __shared__ unsigned int cnt_blk[GABOR_KMAX];  // this block's counts
  __shared__ unsigned int cnt_s[GABOR_KMAX];    // the ROI's, in block 0
  __shared__ int rowflag[GABOR_ROWS_MAX];       // a window row not all zero
  const int KP = (2 * G * KG + VN - 1) / VN * VN;
  T* taps_s = reinterpret_cast<T*>(gabor_smem);
  const int nn = n * n;
  T* win = taps_s + nn * KP;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int h = min(heights[static_cast<size_t>(b) * hs], H);
  const int w = min(widths[static_cast<size_t>(b) * ws], W);
  const int sw = (w + P - 1) / P;  // strips a row
  const int items = h * sw * G;
  // the ROI's items split evenly over the cluster: at most GABOR_THREADS a
  // block, since the plan holds the bucket's
  const int per = (items + C - 1) / C;
  const int it0 = rank * per;
  const int it1 = min(items, it0 + per);
  const int it = it0 + threadIdx.x;
  const bool busy = it0 < it1;  // uniform over the block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < GABOR_KMAX) cnt_blk[threadIdx.x] = cnt_s[threadIdx.x] = 0u;

  // the window: the block's strips [s0, s1] lie on output rows [r0, r1],
  // which read input rows r0 + off - (n - 1) .. r1 + off and columns
  // off - (n - 1) .. sw * P - 1 + off
  const int off = (n + 1) / 2;
  const int r0 = busy ? it0 / G / sw : 0;
  const int r1 = busy ? (it1 - 1) / G / sw : 0;
  const int wr = r1 - r0 + n;
  const int wc = sw * P + n - 1;
  if (busy) {
    // the taps (16-byte vectors) and the window (zero outside the bucket),
    // copied asynchronously: every copy of the block in flight at once
    const int nv = nn * KP / VN;
    for (int k = threadIdx.x; k < nv; k += GABOR_THREADS)
      nyx_cp16(taps_s + k * VN, taps + k * VN);
    const T* im = img + static_cast<size_t>(H) * W * b;
    const int gy0 = r0 + off - (n - 1);
    const int gx0 = off - (n - 1);
    for (int k = threadIdx.x; k < wr * wc; k += GABOR_THREADS) {
      const int ry = k / wc;
      const int gy = gy0 + ry;
      const int gx = gx0 + (k - ry * wc);
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      gabor_cp_zfill(win + k, in ? im + static_cast<size_t>(gy) * W + gx : im,
                     in);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();
  if (busy) {  // which window rows hold a non-zero: a warp a row
    for (int ry = warp; ry < wr; ry += NW) {
      bool nz = false;
      for (int k = lane; k < wc; k += 32) nz |= win[ry * wc + k] != T(0);
      nz = __any_sync(0xffffffffu, nz);
      if (lane == 0) rowflag[ry] = nz;
    }
  }
  __syncthreads();

  // the KG filters' magnitudes at this thread's P pixels, kept in registers
  const bool valid = it < it1;
  const int s = valid ? it / G : 0;
  const int g = valid ? it - s * G : 0;
  const int y = s / sw;
  const int x0 = (s - y * sw) * P;
  T mag[KG][P];
  if (valid) {
    T re[KG][P], imv[KG][P];
#pragma unroll
    for (int q = 0; q < KG; ++q)
#pragma unroll
      for (int p = 0; p < P; ++p) re[q][p] = imv[q][p] = T(0);
    const int ly = y - r0;
    const unsigned int act = __activemask();
    for (int i = 0; i < n; ++i) {
      // a window row of zeros adds only zeros (a zero's sign never reaches
      // the magnitude): skipped when it is so for every lane
      const int wrow = ly + n - 1 - i;
      if (__all_sync(act, rowflag[wrow] == 0)) continue;
      // tap (i, j) reads window column x0 + p + n - 1 - j: one new value
      // a tap as j rises
      const T* row = win + wrow * wc + x0;
      const V2* tv =
          reinterpret_cast<const V2*>(taps_s + i * n * KP + 2 * g * KG);
      T a[P];
#pragma unroll
      for (int p = 0; p < P; ++p) a[p] = row[n - 1 + p];
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        V2 t[KG];
#pragma unroll
        for (int q = 0; q < KG; ++q) t[q] = tv[q];
        tv += KP / 2;
#pragma unroll
        for (int q = 0; q < KG; ++q)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            re[q][p] = g_add(re[q][p], g_mul(a[p], t[q].x));
            imv[q][p] = g_add(imv[q][p], g_mul(a[p], t[q].y));
          }
        if (j + 1 < n) {
#pragma unroll
          for (int p = P - 1; p > 0; --p) a[p] = a[p - 1];
          a[0] = row[n - 2 - j];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < KG; ++q)
#pragma unroll
      for (int p = 0; p < P; ++p)
        mag[q][p] = floor(sqrt(g_add(g_mul(re[q][p], re[q][p]),
                                     g_mul(imv[q][p], imv[q][p]))));
  }

  // the ROI's baseline max and min: warp, block, then cluster
  T mx = -static_cast<T>(INFINITY);
  T mn = static_cast<T>(INFINITY);
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (valid && g == 0 && x0 + p < w) {
      mx = fmax(mx, mag[0][p]);
      mn = fmin(mn, mag[0][p]);
    }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  if (lane == 0) {
    part_max[warp] = mx;
    part_min[warp] = mn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < NW; ++k) {
      mx = fmax(mx, part_max[k]);
      mn = fmin(mn, part_min[k]);
    }
    blk_ext[0] = mx;
    blk_ext[1] = mn;
  }
  cluster.sync();  // every block's extrema (and block 0's zeroed counts)
  if (warp == 0) {
    mx = -static_cast<T>(INFINITY);
    mn = static_cast<T>(INFINITY);
    if (lane < C) {
      const T* e = cluster.map_shared_rank(blk_ext, lane);
      mx = e[0];
      mn = e[1];
    }
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mn = fmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    if (lane == 0) {
      roi_ext[0] = mx;
      roi_ext[1] = mn;
    }
  }
  __syncthreads();
  mx = roi_ext[0];
  mn = roi_ext[1];

  // the counts: the baseline above its min, each filter above the
  // threshold; a warp sum (one group) or a lane's add into the block's,
  // then the block's into block 0's
  const T denom = fmax(mx, static_cast<T>(1e-30));
#pragma unroll
  for (int q = 0; q < KG; ++q) {
    const int f = g * KG + q;
    unsigned int c = 0u;
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (valid && f < K && x0 + p < w)
        c += f == 0 ? (mag[q][p] > mn) : (mag[q][p] / denom > thold);
    if (G == 1) {  // uniform
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0 && c) atomicAdd(cnt_blk + q, c);
    } else if (c) {
      atomicAdd(cnt_blk + f, c);
    }
  }
  __syncthreads();
  if (threadIdx.x < K && cnt_blk[threadIdx.x])
    nyx_red_add(nyx_mapa(cnt_s + threadIdx.x, 0u), cnt_blk[threadIdx.x]);
  cluster.sync();  // every count added; no block reads another's after
  if (rank == 0) {
    if (threadIdx.x < K)
      counts[static_cast<size_t>(b) * K + threadIdx.x] =
          static_cast<int>(cnt_s[threadIdx.x]);
    if (threadIdx.x == 0) {
      maxval[b] = mx;
      cmpval[b] = mn;
    }
  }
}

template <typename T, int KG, int P>
static int gabor_cluster_launch(const void* img, const void* taps,
                                const void* heights, const void* widths,
                                int hs, int ws, void* counts, void* maxval,
                                void* cmpval, int B, int H, int W, int n,
                                int K, int G, double thold, int C,
                                size_t smem, cudaStream_t st) {
  auto kern = gabor_cluster_kernel<T, KG, P>;
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, smem, C, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * C, 1, 1);
  cfg.blockDim = dim3(GABOR_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(img),
                         static_cast<const T*>(taps),
                         static_cast<const int*>(heights),
                         static_cast<const int*>(widths), hs, ws,
                         static_cast<int*>(counts), static_cast<T*>(maxval),
                         static_cast<T*>(cmpval), H, W, n, K, G, C,
                         static_cast<T>(thold));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
static int gabor_cluster_kg(const void* img, const void* taps,
                            const void* heights, const void* widths, int hs,
                            int ws, void* counts, void* maxval, void* cmpval,
                            int B, int H, int W, int n, int K, int KG, int G,
                            double thold, int C, size_t smem,
                            cudaStream_t st) {
#define GABOR_KG_CASE(kg)                                                    \
  case kg:                                                                  \
    return gabor_cluster_launch<T, kg, P>(img, taps, heights, widths, hs,   \
                                          ws, counts, maxval, cmpval, B, H, \
                                          W, n, K, G, thold, C, smem, st);
  switch (KG) {
    GABOR_KG_CASE(1)
    GABOR_KG_CASE(2)
    GABOR_KG_CASE(3)
    GABOR_KG_CASE(4)
    GABOR_KG_CASE(5)
    GABOR_KG_CASE(6)
    GABOR_KG_CASE(7)
    GABOR_KG_CASE(8)
  }
#undef GABOR_KG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The tile path

template <typename T>
static int gabor_tile_launch(const void* img, const void* taps,
                             const void* heights, const void* widths, int hs,
                             int ws, void* base, void* maxval, void* cmpval,
                             void* counts, int B, int H, int W, int n, int K,
                             double thold, cudaStream_t st) {
  const int tiles_x = (W + GABOR_TILE - 1) / GABOR_TILE;
  const int tiles_y = (H + GABOR_TILE - 1) / GABOR_TILE;
  const long long nblocks = static_cast<long long>(B) * tiles_x * tiles_y;
  if (nblocks > 0x7fffffffLL)
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
      static_cast<const int*>(heights), static_cast<const int*>(widths), hs,
      ws, static_cast<T*>(base), static_cast<T*>(maxval),
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
      static_cast<const int*>(heights), static_cast<const int*>(widths), hs,
      ws, static_cast<const T*>(base), static_cast<const T*>(maxval),
      static_cast<const T*>(cmpval), static_cast<int*>(counts), H, W, n, K,
      static_cast<T>(thold), tiles_x, tiles, use_tile, use_taps2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int gabor_launch(const void* img, const void* taps,
                        const void* heights, const void* widths, int hs,
                        int ws, void* base, void* maxval, void* cmpval,
                        void* counts, int B, int H, int W, int n, int K,
                        double thold, int C, int P, int KG, size_t smem,
                        cudaStream_t st) {
  if (n < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 0)
    return gabor_tile_launch<T>(img, taps, heights, widths, hs, ws, base,
                                maxval, cmpval, counts, B, H, W, n, K, thold,
                                st);
  const int G = KG >= 1 ? (K + KG - 1) / KG : 0;
  if (C < 0 || C > GABOR_CLUSTER_MAX || K > GABOR_KMAX || KG < 1 ||
      KG > GABOR_KMAX || (P != 1 && P != 2) ||
      static_cast<long long>(B) * C > 0x7fffffffLL ||
      smem + GABOR_STATIC_SMEM > GABOR_SMEM_MAX ||
      static_cast<long long>(H) * ((W + P - 1) / P) * G >
          static_cast<long long>(C) * GABOR_THREADS ||
      GABOR_THREADS + n > GABOR_ROWS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 1)
    return gabor_cluster_kg<T, 1>(img, taps, heights, widths, hs, ws, counts,
                                  maxval, cmpval, B, H, W, n, K, KG, G, thold,
                                  C, smem, st);
  return gabor_cluster_kg<T, 2>(img, taps, heights, widths, hs, ws, counts,
                                maxval, cmpval, B, H, W, n, K, KG, G, thold, C,
                                smem, st);
}

// img: [B, H, W] masked intensities; heights, widths: int32, ROI b's at
// b * hs and b * ws; counts: int32 [B, K]; maxval / cmpval: [B].  C > 0:
// the cluster path, C blocks a ROI, P pixels and KG filters a thread, smem
// dynamic bytes (ops/gabor.py gabor_plan), taps: [n * n, KP] (tap_rows);
// counts, maxval and cmpval are written, base is not read.  C == 0: the
// tile path; taps: [K, 2, n, n] of the same type (the baseline filter
// first), base: [B, H, W] scratch, maxval / cmpval preset to -inf / +inf,
// counts zeroed.
extern "C" int nyx_gabor(const void* img, const void* taps,
                         const void* heights, const void* widths, int hs,
                         int ws, void* base, void* maxval, void* cmpval,
                         void* counts, int B, int H, int W, int n, int K,
                         double thold, int C, int P, int KG, long long smem,
                         int is_f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t sm = static_cast<size_t>(smem);
  if (is_f64)
    return gabor_launch<double>(img, taps, heights, widths, hs, ws, base,
                                maxval, cmpval, counts, B, H, W, n, K, thold,
                                C, P, KG, sm, st);
  return gabor_launch<float>(img, taps, heights, widths, hs, ws, base, maxval,
                             cmpval, counts, B, H, W, n, K, thold, C, P, KG,
                             sm, st);
}
