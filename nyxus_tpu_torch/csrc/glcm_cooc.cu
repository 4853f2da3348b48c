// K2 glcm_cooc: grey-level co-occurrence counts for every requested angle,
// with the shift, the background test and the count fused.
//
// Replaces nyxus_tpu/ops/glcm.py:61 cooc_matrices (shifted2d copies plus a
// one-hot matmul per angle on the TPU).  A pixel pair counts when the
// centre's and the neighbour's ORIGINAL intensity are both > 0 (NaN is
// not) and both levels lie in 1..ng; the neighbour of (y, x) is (y + dy,
// x + dx) and pixels outside the crop count as intensity 0, exactly as
// shifted2d fills them.  Axis 2 of the output is the NEIGHBOUR level - 1,
// axis 3 the CENTRE level - 1; ``symmetric`` adds the transpose.
//
// Every path stages its crop as 16-bit codes (where it fits a block and
// ng < 65536): 0 where the pixel does not count (intensity <= 0 or NaN, or
// a level outside 1..ng) else its level, with a ring of 0 as wide as the
// offset, so that a pair counts iff both codes are non-zero and the
// neighbour read needs no bounds test and no division.  The crop is read
// once, with 16-byte loads where its rows allow.  ops/glcm.py
// glcm_cooc_plan picks the path, the count width, the angles a block and
// the blocks a ROI:
// - "smem": one block a ROI and group of AG angles (two at 64 levels, one
//   at 256 or where a thread has one pixel).  A thread a pixel (eight where
//   a block would pass 256 threads) reads its code once and, for each
//   angle, its neighbour's, and adds the pair with one shared atomic.  The
//   counts are 16-bit halves of 32-bit words where no cell of the block
//   can pass 65535 (the block's pixels), else 32-bit; a cell's word is
//   XOR-swizzled within its matrix row by the row's index, so that one
//   centre level's cells in different rows fall in different banks.
//   ``symmetric`` adds the transposed cell on write-out.  Each cell is
//   written once, in the compute type, four cells a 16-byte (float) or two
//   (double) store.
// - "cluster": C <= 16 blocks a ROI and angle group form a thread-block
//   cluster; block r stages rows [r R, r R + R) with the offset's halo and
//   counts them into its own copy of the counts; after a cluster barrier
//   it sums its share of the cells over the C copies through distributed
//   shared memory (four copies' loads in flight) and writes them (crops
//   past 4096 pixels: the long ROI's 1024 x 64, also at 256 levels).
// - "device": matrices no block or cluster holds (IBSI's raw 12-bit levels,
//   4096).  A block a ROI and band of matrix rows, of every angle: it
//   zeroes its band of the output, stages the whole crop (or, past a
//   block's shared memory or 65535 levels, reads it from device memory),
//   and counts the pairs whose cell lies in its band (``symmetric``: also
//   those whose transposed cell does), adding 1.0 straight into the output
//   (bits 24 / 53: exact while no cell passes 2^24 in float32, 2^53 in
//   float64), or into an int32 scratch band that it zeroes and converts on
//   write-out (bits 32).
// One launch on every path: no zero fill, no second kernel.  What the card
// showed (PERF.md): grouping a warp's equal cells with __match_any_sync, or
// a warp's runs of lanes by ballot, ran slower than one atomic a pair on
// random crops and no faster on uniform and checkerboard ones; counting
// (j, i) beside (i, j) ran slower than adding the transpose on write-out;
// four angles a block, or 1024 threads of one pixel each, left the write
// to too few SMs; a cap of 32 registers (two 1024-thread blocks an SM)
// spilled and ran slower than 64.
// Bound on the card: bytes (the intensities and levels read once, the
// matrices written once); at the main buckets a launch and one round of
// loads.
#include <cooperative_groups.h>
#include <limits.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define GC_PATH_SMEM 0
#define GC_PATH_CLUSTER 1
#define GC_PATH_DEVICE 2
#define GC_CLUSTER_MAX 16
#define GC_THREADS_MAX 1024
#define GC_ANGLES 4
#define GC_DEAD INT_MIN  // an angle whose neighbours all lie off the crop
// the kernels' static shared memory (the angles' steps), beside the plan's
#define GC_STATIC_SMEM (GC_ANGLES * sizeof(int))

struct NyxAngles {
  int n;
  int dx[GC_ANGLES];
  int dy[GC_ANGLES];
};

// the word of cell key = (a ng + i) ng + j (matrix a, row i, column j) and
// the shift of its 16-bit half: mask + 1 divides a row's words, so the XOR
// stays within the row
template <bool NARROW>
__device__ __forceinline__ int gc_word(int key, int i, int mask, int& shift) {
  shift = NARROW ? (key & 1) << 4 : 0;
  return (NARROW ? key >> 1 : key) ^ (i & mask);
}

template <bool NARROW>
__device__ __forceinline__ unsigned int gc_cell(const unsigned int* cnt,
                                                int a, int i, int j, int ng,
                                                int mask) {
  int sh;
  const unsigned int w =
      cnt[gc_word<NARROW>((a * ng + i) * ng + j, i, mask, sh)] >> sh;
  return NARROW ? w & 0xFFFFu : w;
}

// a pixel's code: its level where it counts, else 0
template <typename T>
__device__ __forceinline__ int gc_code(T v, int l, int ng) {
  return v > T(0) && l >= 1 && l <= ng ? l : 0;
}

template <typename T>
__device__ __forceinline__ void gc_load4(const T* p, T* v);

template <>
__device__ __forceinline__ void gc_load4<float>(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

template <>
__device__ __forceinline__ void gc_load4<double>(const double* p, double* v) {
  const double2 u0 = reinterpret_cast<const double2*>(p)[0];
  const double2 u1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = u0.x; v[1] = u0.y; v[2] = u1.x; v[3] = u1.y;
}

__device__ __forceinline__ void gc_store4(float* p, const unsigned int* s) {
  *reinterpret_cast<float4*>(p) =
      make_float4(static_cast<float>(s[0]), static_cast<float>(s[1]),
                  static_cast<float>(s[2]), static_cast<float>(s[3]));
}

__device__ __forceinline__ void gc_store4(double* p, const unsigned int* s) {
  reinterpret_cast<double2*>(p)[0] =
      make_double2(static_cast<double>(s[0]), static_cast<double>(s[1]));
  reinterpret_cast<double2*>(p)[1] =
      make_double2(static_cast<double>(s[2]), static_cast<double>(s[3]));
}

// Stage crop rows [y0 - hy, y1 + hy) of one ROI as codes, W + 2 hx a row:
// crop pixel (y, x) at code[(hy - y0 + y) (W + 2 hx) + hx + x], 0 on the
// ring and on the rows off the crop.  The caller synchronises.
template <typename T>
__device__ __forceinline__ void gc_stage(unsigned short* code,
                                         const T* __restrict__ ob,
                                         const int* __restrict__ lb, int H,
                                         int W, int ng, int y0, int y1,
                                         int hx, int hy, int vec, int tid,
                                         int nt) {
  const int SW = W + 2 * hx;
  const int LR = y1 - y0 + 2 * hy;
  if (hx)
    for (int k = tid; k < LR * 2 * hx; k += nt) {
      const int r = k / (2 * hx), c = k - r * 2 * hx;
      code[r * SW + (c < hx ? c : W + c)] = 0;
    }
  const int ylo = max(0, y0 - hy), yhi = min(H, y1 + hy);
  const int top = ylo - (y0 - hy), bot = y1 + hy - yhi;
  for (int k = tid; k < (top + bot) * W; k += nt) {
    const int r = k / W, x = k - r * W;
    code[(r < top ? r : LR - bot + r - top) * SW + hx + x] = 0;
  }
  const int sb = (hy - y0) * SW + hx;
  const int qa = ylo * W, qb = yhi * W;
  if (vec) {
    for (int q = qa + 4 * tid; q < qb; q += 4 * nt) {
      const int4 l = *reinterpret_cast<const int4*>(lb + q);
      T v[4];
      gc_load4<T>(ob + q, v);
      const int y = q / W, x = q - y * W;
      unsigned short* d = code + sb + y * SW + x;
      d[0] = static_cast<unsigned short>(gc_code(v[0], l.x, ng));
      d[1] = static_cast<unsigned short>(gc_code(v[1], l.y, ng));
      d[2] = static_cast<unsigned short>(gc_code(v[2], l.z, ng));
      d[3] = static_cast<unsigned short>(gc_code(v[3], l.w, ng));
    }
  } else {
    for (int q = qa + tid; q < qb; q += nt) {
      const int y = q / W, x = q - y * W;
      code[sb + y * SW + x] =
          static_cast<unsigned short>(gc_code(ob[q], lb[q], ng));
    }
  }
}

// the stage step of angles [a0, a0 + nd), GC_DEAD where it leaves the crop
__device__ __forceinline__ void gc_steps(int* doff, const NyxAngles& ang,
                                         int a0, int nd, int H, int W,
                                         int SW, int tid) {
  if (tid < nd) {
    const int dx = ang.dx[a0 + tid], dy = ang.dy[a0 + tid];
    doff[tid] = abs(dx) < W && abs(dy) < H ? dy * SW + dx : GC_DEAD;
  }
}

// ---------------------------------------------------------------------------
// The shared-memory and cluster paths

// out: [B, n, ng, ng] of T, every cell written once.  Block (or cluster)
// (ROI b, angle group g) counts angles [g AG, g AG + AG) cut at n; on the
// cluster path block r of the cluster takes crop rows [r R, r R + R).
// Shared memory: the counts (words, swizzled; a multiple of 4 words), then
// the staged rows.
template <typename T, int PATH, bool NARROW>
__global__ void __launch_bounds__(GC_THREADS_MAX, 1)
    glcm_cooc_kernel(const T* __restrict__ orig, const int* __restrict__ lev,
                     T* __restrict__ out, int H, int W, int ng, NyxAngles ang,
                     int symmetric, int AG, int R, int hx, int hy, int vec) {
  extern __shared__ __align__(16) unsigned int gc_smem[];
  __shared__ int doff[GC_ANGLES];
  const int groups = (ang.n + AG - 1) / AG;
  int cl = blockIdx.x, rank = 0, nblk = 1;
  if constexpr (PATH == GC_PATH_CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    nblk = static_cast<int>(cg::this_cluster().num_blocks());
    cl = blockIdx.x / nblk;
  }
  const int b = cl / groups;
  const int a0 = (cl - b * groups) * AG;
  const int nd = min(AG, ang.n - a0);
  const int n2 = ng * ng;
  const int mask = nyx_swizzle_mask(ng, NARROW);
  const int y0 = rank * R, y1 = min(H, y0 + R);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int words = NARROW ? (AG * n2 + 1) / 2 : AG * n2;
  const int cwords = (words + 3) & ~3;
  unsigned int* cnt = gc_smem;
  unsigned short* code = reinterpret_cast<unsigned short*>(gc_smem + cwords);
  const int SW = W + 2 * hx;
  const long long base = static_cast<long long>(b) * H * W;

  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  for (int k = tid; k < cwords / 4; k += nt) c4[k] = make_uint4(0u, 0u, 0u, 0u);
  gc_stage(code, orig + base, lev + base, H, W, ng, y0, y1, hx, hy, vec, tid,
           nt);
  gc_steps(doff, ang, a0, nd, H, W, SW, tid);
  __syncthreads();

  // every pixel of the block's rows, (y, x) stepped without a division: one
  // shared atomic a pair and angle
  const int npx = (y1 - y0) * W;
  if (npx > 0) {
    int off[GC_ANGLES];
#pragma unroll
    for (int a = 0; a < GC_ANGLES; ++a) off[a] = a < nd ? doff[a] : GC_DEAD;
    const int sb = (hy - y0) * SW + hx;
    const int sy = nt / W, sx = nt - sy * W;
    int y = y0 + tid / W, x = tid - (tid / W) * W;
    for (int p = tid; p < npx; p += nt) {
      const int ci = sb + y * SW + x;
      const int c = code[ci];
      if (c) {
#pragma unroll
        for (int a = 0; a < GC_ANGLES; ++a) {
          const int n = off[a] != GC_DEAD ? code[ci + off[a]] : 0;
          if (n) {
            int sh;
            const int w =
                gc_word<NARROW>((a * ng + n - 1) * ng + c - 1, n - 1, mask, sh);
            atomicAdd(cnt + w, 1u << sh);
          }
        }
      }
      x += sx;
      y += sy;
      if (x >= W) {
        x -= W;
        ++y;
      }
    }
  }

  // each cell written once, in the compute type (the transposed cell added
  // where symmetric): on the cluster path block r sums its share of the
  // cells over the cluster's copies (distributed shared memory)
  if constexpr (PATH == GC_PATH_CLUSTER)
    cg::this_cluster().sync();
  else
    __syncthreads();
  auto copy = [&](int r) -> const unsigned int* {
    if constexpr (PATH == GC_PATH_CLUSTER)
      return cg::this_cluster().map_shared_rank(cnt, r);
    else
      return cnt;
  };
  T* o = out + (static_cast<long long>(b) * ang.n + a0) * n2;
  const int ncell = nd * n2;
  if ((ng & 3) == 0) {
    // four cells (i, j..j + 3) of matrix a a thread: one 8-byte (NARROW)
    // or 16-byte load of their words from each copy, four copies' loads in
    // flight, and one 16-byte store; (a, i, j) stepped without a division
    // but at a matrix's end
    const int nq = ncell >> 2, qr = ng >> 2;
    const int per = (nq + nblk - 1) / nblk;
    const int q0 = min(nq, rank * per), q1 = min(nq, q0 + per);
    const int sr = nt / qr, sj = (nt - sr * qr) << 2;
    int i = (q0 + tid) / qr, j = ((q0 + tid) - i * qr) << 2;
    int a = i / ng;
    i -= a * ng;
    for (int q = q0 + tid; q < q1; q += nt) {
      const int m = i & mask;
      const int ri = a * ng + i;
      const int w = NARROW ? ri * (ng >> 1) + (((j >> 1) ^ m) & ~1)
                           : ri * ng + ((j ^ m) & ~3);
      unsigned int s[4] = {0u, 0u, 0u, 0u};
      for (int r0 = 0; r0 < nblk; r0 += 4) {
        if (NARROW) {
          uint2 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r0 + u < nblk)
              v[u] = *reinterpret_cast<const uint2*>(copy(r0 + u) + w);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (r0 + u >= nblk) break;
            const unsigned int lo = m & 1 ? v[u].y : v[u].x;
            const unsigned int hi = m & 1 ? v[u].x : v[u].y;
            s[0] += lo & 0xFFFFu;
            s[1] += lo >> 16;
            s[2] += hi & 0xFFFFu;
            s[3] += hi >> 16;
          }
        } else {
          // cell j + t sits at element t ^ (m & 3)
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (r0 + u < nblk)
              v[u] = *reinterpret_cast<const uint4*>(copy(r0 + u) + w);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (r0 + u >= nblk) break;
            uint4 e = v[u];
            if (m & 1) e = make_uint4(e.y, e.x, e.w, e.z);
            if (m & 2) e = make_uint4(e.z, e.w, e.x, e.y);
            s[0] += e.x;
            s[1] += e.y;
            s[2] += e.z;
            s[3] += e.w;
          }
        }
      }
      if (symmetric)
        for (int r = 0; r < nblk; ++r) {
          const unsigned int* cr = copy(r);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            s[t] += gc_cell<NARROW>(cr, a, j + t, i, ng, mask);
        }
      gc_store4(o + 4 * static_cast<long long>(q), s);
      j += sj;
      i += sr;
      if (j >= ng) {
        j -= ng;
        ++i;
      }
      if (i >= ng) {
        const int d = i / ng;
        a += d;
        i -= d * ng;
      }
    }
  } else {
    const int per = (ncell + nblk - 1) / nblk;
    const int k0 = min(ncell, rank * per), k1 = min(ncell, k0 + per);
    for (int k = k0 + tid; k < k1; k += nt) {
      const int a = k / n2, r2 = k - a * n2;
      const int i = r2 / ng, j = r2 - i * ng;
      unsigned int s = 0u;
      for (int r = 0; r < nblk; ++r) {
        const unsigned int* cr = copy(r);
        s += gc_cell<NARROW>(cr, a, i, j, ng, mask);
        if (symmetric) s += gc_cell<NARROW>(cr, a, j, i, ng, mask);
      }
      o[k] = static_cast<T>(s);
    }
  }
  if constexpr (PATH == GC_PATH_CLUSTER)
    cg::this_cluster().sync();  // no block leaves while others read it
}

// ---------------------------------------------------------------------------
// The device-memory path

// zero n elements from p: 16-byte stores over the aligned middle
template <typename U>
__device__ __forceinline__ void gc_zero(U* p, long long n, int tid, int nt) {
  const long long mis = reinterpret_cast<unsigned long long>(p) & 15;
  long long head = mis ? (16 - mis) / static_cast<long long>(sizeof(U)) : 0;
  if (head > n) head = n;
  const long long nv = (n - head) * sizeof(U) / 16;
  const long long tail = head + nv * 16 / static_cast<long long>(sizeof(U));
  for (long long k = tid; k < head; k += nt) p[k] = U(0);
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (long long k = tid; k < nv; k += nt) v[k] = make_uint4(0u, 0u, 0u, 0u);
  for (long long k = tail + tid; k < n; k += nt) p[k] = U(0);
}

// Block (ROI b, band k) owns rows [k BR, k BR + BR) of each angle's matrix:
// it zeroes them and counts the pairs whose cell (or, symmetric, whose
// transposed cell) lies there into the output (I32 false) or into the int32
// scratch dcount ([B, n, ng, ng]) and then converts them.  STAGED: the
// whole crop staged as codes in dynamic shared memory.
template <typename T, bool I32, bool STAGED>
__global__ void __launch_bounds__(GC_THREADS_MAX)
    glcm_cooc_device_kernel(const T* __restrict__ orig,
                            const int* __restrict__ lev, T* __restrict__ out,
                            unsigned int* __restrict__ dcount, int H, int W,
                            int ng, NyxAngles ang, int symmetric, int nb,
                            int BR, int hx, int hy, int vec) {
  extern __shared__ __align__(16) unsigned short gc_code_smem[];
  __shared__ int doff[GC_ANGLES];
  const int b = blockIdx.x / nb, band = blockIdx.x - b * nb;
  const int i0 = band * BR, i1 = min(ng, i0 + BR);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int na = ang.n;
  const long long n2 = static_cast<long long>(ng) * ng;
  T* o = out + static_cast<long long>(b) * na * n2;
  unsigned int* dc = I32 ? dcount + static_cast<long long>(b) * na * n2
                         : nullptr;
  for (int a = 0; a < na; ++a) {
    const long long c0 = a * n2 + static_cast<long long>(i0) * ng;
    const long long len = static_cast<long long>(i1 - i0) * ng;
    if (I32)
      gc_zero(dc + c0, len, tid, nt);
    else
      gc_zero(o + c0, len, tid, nt);
  }
  const long long base = static_cast<long long>(b) * H * W;
  const T* ob = orig + base;
  const int* lb = lev + base;
  const int SW = W + 2 * hx;
  if constexpr (STAGED) {
    gc_stage(gc_code_smem, ob, lb, H, W, ng, 0, H, hx, hy, vec, tid, nt);
    gc_steps(doff, ang, 0, na, H, W, SW, tid);
  }
  __syncthreads();  // the band zeroed before any of its atomics

  int off[GC_ANGLES];
#pragma unroll
  for (int a = 0; a < GC_ANGLES; ++a)
    off[a] = a >= na ? GC_DEAD : STAGED ? doff[a] : 0;
  const unsigned int band_rows = static_cast<unsigned int>(i1 - i0);
  auto add = [&](long long cell) {
    if (I32)
      atomicAdd(dc + cell, 1u);
    else
      atomicAdd(o + cell, T(1));
  };
  const int npx = H * W;
  if (npx > 0) {
    const int sy = nt / W, sx = nt - sy * W;
    int y = tid / W, x = tid - (tid / W) * W;
    for (int p = tid; p < npx; p += nt) {
      const int ci = hy * SW + hx + y * SW + x;
      const int c = STAGED ? gc_code_smem[ci] : gc_code(ob[p], lb[p], ng);
      if (c) {
        const bool cin = static_cast<unsigned int>(c - 1 - i0) < band_rows;
#pragma unroll
        for (int a = 0; a < GC_ANGLES; ++a) {
          if (off[a] == GC_DEAD) continue;
          int n;
          if constexpr (STAGED) {
            n = gc_code_smem[ci + off[a]];
          } else {
            const int ny = y + ang.dy[a], nx = x + ang.dx[a];
            n = ny >= 0 && ny < H && nx >= 0 && nx < W
                    ? gc_code(ob[ny * W + nx], lb[ny * W + nx], ng)
                    : 0;
          }
          if (!n) continue;
          const long long m0 = a * n2;
          if (static_cast<unsigned int>(n - 1 - i0) < band_rows)
            add(m0 + static_cast<long long>(n - 1) * ng + c - 1);
          if (symmetric && cin)
            add(m0 + static_cast<long long>(c - 1) * ng + n - 1);
        }
      }
      x += sx;
      y += sy;
      if (x >= W) {
        x -= W;
        ++y;
      }
    }
  }
  if (I32) {
    __syncthreads();  // the band's atomics done; read them past L1
    for (int a = 0; a < na; ++a) {
      const long long c0 = a * n2 + static_cast<long long>(i0) * ng;
      const long long len = static_cast<long long>(i1 - i0) * ng;
      for (long long k = tid; k < len; k += nt)
        o[c0 + k] = static_cast<T>(__ldcg(dc + c0 + k));
    }
  }
}

// ---------------------------------------------------------------------------
// Launch

template <typename T, int PATH, bool NARROW>
static int gc_launch(const void* orig, const void* lev, void* out, int B,
                     int H, int W, int ng, const NyxAngles& ang,
                     int symmetric, int AG, int C, int threads, int smem,
                     int hx, int hy, int vec, cudaStream_t st) {
  auto kern = glcm_cooc_kernel<T, PATH, NARROW>;
  const int R = PATH == GC_PATH_CLUSTER ? (H + C - 1) / C : H;
  const unsigned int blocks = static_cast<unsigned int>(B) *
                              ((ang.n + AG - 1) / AG) *
                              (PATH == GC_PATH_CLUSTER ? C : 1);
  if (PATH != GC_PATH_CLUSTER) {
    cudaError_t e =
        nyx_allow_smem(kern, static_cast<size_t>(smem), GC_STATIC_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<blocks, threads, smem, st>>>(
        static_cast<const T*>(orig), static_cast<const int*>(lev),
        static_cast<T*>(out), H, W, ng, ang, symmetric, AG, R, hx, hy, vec);
    return static_cast<int>(cudaGetLastError());
  }
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, static_cast<size_t>(smem), C, &done,
                                    GC_STATIC_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(orig),
                         static_cast<const int*>(lev), static_cast<T*>(out),
                         H, W, ng, ang, symmetric, AG, R, hx, hy, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool I32, bool STAGED>
static int gc_launch_device(const void* orig, const void* lev, void* out,
                            void* dcount, int B, int H, int W, int ng,
                            const NyxAngles& ang, int symmetric, int C,
                            int threads, int smem, int hx, int hy, int vec,
                            cudaStream_t st) {
  auto kern = glcm_cooc_device_kernel<T, I32, STAGED>;
  cudaError_t e =
      nyx_allow_smem(kern, static_cast<size_t>(smem), GC_STATIC_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned int>(B) * C, threads, smem, st>>>(
      static_cast<const T*>(orig), static_cast<const int*>(lev),
      static_cast<T*>(out), static_cast<unsigned int*>(dcount), H, W, ng, ang,
      symmetric, C, (ng + C - 1) / C, hx, hy, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int gc_dispatch(const void* orig, const void* lev, void* out,
                       void* dcount, int B, int H, int W, int ng,
                       const NyxAngles& ang, int symmetric, int path,
                       int bits, int AG, int C, int threads, int smem, int hx,
                       int hy, int vec, cudaStream_t st) {
  if (threads < 32 || threads > GC_THREADS_MAX || threads % 32 != 0 ||
      ang.n < 1 || ang.n > GC_ANGLES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == GC_PATH_DEVICE) {
    const bool i32 = bits == 32;
    if (C < 1 || (i32 && !dcount) ||
        (!i32 && bits != (sizeof(T) == 8 ? 53 : 24)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (i32)
      return smem ? gc_launch_device<T, true, true>(
                        orig, lev, out, dcount, B, H, W, ng, ang, symmetric,
                        C, threads, smem, hx, hy, vec, st)
                  : gc_launch_device<T, true, false>(
                        orig, lev, out, dcount, B, H, W, ng, ang, symmetric,
                        C, threads, smem, hx, hy, vec, st);
    return smem ? gc_launch_device<T, false, true>(
                      orig, lev, out, dcount, B, H, W, ng, ang, symmetric, C,
                      threads, smem, hx, hy, vec, st)
                : gc_launch_device<T, false, false>(
                      orig, lev, out, dcount, B, H, W, ng, ang, symmetric, C,
                      threads, smem, hx, hy, vec, st);
  }
  if (AG < 1 || AG > GC_ANGLES || (bits != 16 && bits != 32) ||
      (path == GC_PATH_CLUSTER && (C < 2 || C > GC_CLUSTER_MAX)) ||
      (path != GC_PATH_SMEM && path != GC_PATH_CLUSTER))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == GC_PATH_SMEM)
    return bits == 16
               ? gc_launch<T, GC_PATH_SMEM, true>(orig, lev, out, B, H, W, ng,
                                                  ang, symmetric, AG, C,
                                                  threads, smem, hx, hy, vec,
                                                  st)
               : gc_launch<T, GC_PATH_SMEM, false>(orig, lev, out, B, H, W,
                                                   ng, ang, symmetric, AG, C,
                                                   threads, smem, hx, hy, vec,
                                                   st);
  return bits == 16
             ? gc_launch<T, GC_PATH_CLUSTER, true>(orig, lev, out, B, H, W,
                                                   ng, ang, symmetric, AG, C,
                                                   threads, smem, hx, hy, vec,
                                                   st)
             : gc_launch<T, GC_PATH_CLUSTER, false>(orig, lev, out, B, H, W,
                                                    ng, ang, symmetric, AG, C,
                                                    threads, smem, hx, hy,
                                                    vec, st);
}

// orig: [B, H, W] of the compute type; lev: [B, H, W] int32; out: [B,
// n_angles, ng, ng] of the compute type; dcount: the device path's int32
// scratch of out's shape at bits 32, else unused.  (dxk, dyk): angle k's
// step, offset included.  path 0 "smem" (a block a ROI and group of AG
// angles), 1 "cluster" (C blocks of ceil(H / C) rows a ROI and group), 2
// "device" (C blocks a ROI, each a band of ceil(ng / C) matrix rows of
// every angle); bits: 16 or 32 (shared counts), 24 / 53 (the device path's
// float adds into out) or 32 (its int32 scratch); smem: the dynamic shared
// memory the plan computed (the device path's staged crop, 0 to read the
// crop from device memory); hx, hy: the staged ring's width; vec: W % 4 ==
// 0 and both crops 16-byte aligned.
extern "C" int nyx_glcm_cooc(const void* orig, const void* lev, void* out,
                             void* dcount, int B, int H, int W, int ng,
                             int n_angles, int dx0, int dy0, int dx1, int dy1,
                             int dx2, int dy2, int dx3, int dy3,
                             int symmetric, int path, int bits, int AG, int C,
                             int threads, int smem, int hx, int hy, int vec,
                             int is_f64, void* stream) {
  NyxAngles ang;
  ang.n = n_angles;
  ang.dx[0] = dx0; ang.dy[0] = dy0;
  ang.dx[1] = dx1; ang.dy[1] = dy1;
  ang.dx[2] = dx2; ang.dy[2] = dy2;
  ang.dx[3] = dx3; ang.dy[3] = dy3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? gc_dispatch<double>(orig, lev, out, dcount, B, H, W, ng,
                                      ang, symmetric, path, bits, AG, C,
                                      threads, smem, hx, hy, vec, st)
                : gc_dispatch<float>(orig, lev, out, dcount, B, H, W, ng, ang,
                                     symmetric, path, bits, AG, C, threads,
                                     smem, hx, hy, vec, st);
}
