// K13 glcm3d_cooc: 3D grey-level co-occurrence counts over the 13
// directions of the reference's 3D GLCM, with the shift, the cube test and
// the count fused.
//
// Replaces nyxus_tpu/ops/texture3d.py:81 glcm3d_all's matrix build (13
// shifted3d copies of the levels and the AABB mask, then a pair_hist
// scatter per direction on the TPU).  A voxel pair counts when the centre v
// and its neighbour v + offset * (dx, dy, dz) both lie in the ROI's AABB
// cube (depths x heights x widths; the background inside the cube takes
// part, as the reference's MATLAB mode has it).  Axis 2 of the output is the
// NEIGHBOUR level - 1, axis 3 the CENTRE level - 1 (pair_hist(a=nb_lev,
// b=lev_idx)); pairs with a level outside 1..ng are dropped, which is also
// IBSI mode's extra test (levels > 0 at both ends).  ``symmetric`` adds the
// transpose on write-out (the reference symmetrises only at greyInfo 0).
//
// Two designs, chosen by the wrapper's plan (ops/texture3d.py glcm3d_plan):
//
// The cluster path, one launch: a thread-block cluster of C <= 8 blocks for
// each ROI and group of DG of the 13 directions.  Each block holds its
// directions' ng x ng matrices in shared memory, as 16-bit halves of 32-bit
// words when no block can count more than 65535 into a cell, else 32-bit.
// The ROI's AABB cube is cut into bricks of Zb planes x Yb rows x the whole
// width; block r takes bricks r, r + C, ...  A block stages a brick once,
// with the offset's halo on every side, as 8-bit levels (0 for a level
// outside 1..ng and for a voxel outside the cube, so a pair counts when
// both ends are non-zero and no bounds test is left): the stage is zeroed,
// then the in-cube rows are read with 16-byte loads, several in flight a
// thread.  For each of its directions a thread walks segments of 8 voxels
// along x, the segment's levels loaded first, carrying the cell it counts
// and its run in registers: a run of one cell (the background, a uniform
// region) costs one shared atomic.  A cell's word is swizzled within its
// matrix row so that one centre level's cells fall in different banks.
// ``symmetric`` adds the transposed cell at count time.  After a cluster
// barrier each block sums its share of the count words over the cluster's
// blocks through distributed shared memory and writes their cells once, in
// the compute dtype.  No int32 buffer, no zeroing launch, no second
// kernel.
//
// What the card showed (PERF.md): the stage and the count are
// latency-bound, so the launch wants many resident blocks.  At 64 levels a
// block holding all 13 matrices (106 KB) kept an SM to one block and ran
// slower than one direction a block (8 KB), and clusters of 16 blocks of
// that size did not all fit the card at once (a second wave); the plan
// puts as many directions in a block as fit GLCM3_SMEM_AIM (all 13 at 8
// levels) in clusters of at most 8.  Grouping a warp's equal cells with
// __match_any_sync, or a warp's runs of lanes with one cell (a shuffle and
// a ballot a direction), measured slower than the per-thread runs.
//
// The device-memory path, where one direction's matrix and a brick of one
// row do not fit a block (256 levels and up: raw 12-bit levels): a grid of
// (ROI, direction, chunk of 8192 voxels) blocks.  Where the ng x ng matrix
// fits a block's shared memory as 32-bit counts each block counts there and
// then adds its non-zero cells into a zeroed int32 [B, 13, ng, ng] buffer
// in device memory; a larger matrix (4 * ng^2 > 227 KB) is counted straight
// into that buffer.  A second launch converts the counts to the compute
// dtype (adding the transpose when symmetric).
//
// Counts are exact in both.  Bound on the card: the level reads (4 bytes a
// voxel) and writing the matrices (13 * ng^2 values a ROI) once.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NYX_GLCM3_CHUNK 8192
#define NYX_GLCM3_THREADS_MAX 512
#define NYX_GLCM3_RUN 8
#define NYX_GLCM3_CLUSTER_MAX 8

struct NyxDirs13 {
  int dz[13];
  int dy[13];
  int dx[13];
};

__global__ void glcm3d_count_kernel(const int* __restrict__ lev,
                                    const int* __restrict__ depths,
                                    const int* __restrict__ heights,
                                    const int* __restrict__ widths, int ds,
                                    int hs, int ws,
                                    unsigned int* __restrict__ gcnt, int D,
                                    int H, int W, int ng, NyxDirs13 dirs,
                                    int in_smem) {
  extern __shared__ unsigned int smem_cnt[];
  const int b = blockIdx.x;
  const int a = blockIdx.y;
  const int n2 = ng * ng;
  unsigned int* g = gcnt + (static_cast<size_t>(b) * 13 + a) * n2;
  unsigned int* cnt = in_smem ? smem_cnt : g;
  if (in_smem) {
    for (int k = threadIdx.x; k < n2; k += blockDim.x) cnt[k] = 0u;
    __syncthreads();
  }
  const int HW = H * W;
  const int A = D * HW;
  const int d = min(depths[static_cast<size_t>(b) * ds], D);
  const int h = min(heights[static_cast<size_t>(b) * hs], H);
  const int w = min(widths[static_cast<size_t>(b) * ws], W);
  const int dz = dirs.dz[a], dy = dirs.dy[a], dx = dirs.dx[a];
  const int* lb = lev + static_cast<size_t>(b) * A;
  const int p0 = blockIdx.z * NYX_GLCM3_CHUNK;
  const int p1 = min(A, p0 + NYX_GLCM3_CHUNK);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    if (z >= d || y >= h || x >= w) continue;
    const int nz = z + dz, ny = y + dy, nx = x + dx;
    if (nz < 0 || nz >= d || ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
    const int i = lb[nz * HW + ny * W + nx] - 1;  // neighbour level
    const int j = lb[p] - 1;                      // centre level
    if (i < 0 || i >= ng || j < 0 || j >= ng) continue;
    atomicAdd(&cnt[i * ng + j], 1u);
  }
  if (in_smem) {
    __syncthreads();
    for (int k = threadIdx.x; k < n2; k += blockDim.x)
      if (cnt[k]) atomicAdd(g + k, cnt[k]);
  }
}

template <typename T>
__global__ void glcm3d_write_kernel(const unsigned int* __restrict__ gcnt,
                                    T* __restrict__ out, long long total,
                                    int ng, int symmetric) {
  const int n2 = ng * ng;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    unsigned int c = gcnt[t];
    if (symmetric) {
      const long long m = t / n2;
      const int k = static_cast<int>(t - m * n2);
      const int i = k / ng;
      const int j = k - i * ng;
      c += gcnt[m * n2 + j * ng + i];
    }
    out[t] = static_cast<T>(c);
  }
}

// ---------------------------------------------------------------------------
// The cluster path

// out: [B, 13, ng, ng] of T, every cell written once.  Cluster (ROI b,
// direction group g) counts the DG directions [g DG, g DG + DG) cut at 13;
// shifts: the 13 (dz, dy, dx) steps scaled by the offset o (the halo).
// Shared memory: this block's counts of its directions (words, swizzled),
// then the stage.
template <typename T, bool NARROW>
__global__ void __launch_bounds__(NYX_GLCM3_THREADS_MAX)
    glcm3d_cluster_kernel(const int* __restrict__ lev,
                          const int* __restrict__ depths,
                          const int* __restrict__ heights,
                          const int* __restrict__ widths, int ds, int hs,
                          int ws, T* __restrict__ out, int D, int H, int W,
                          int ng, int C, int DG, int Zb, int Yb, int o,
                          NyxDirs13 dirs, int symmetric) {
  extern __shared__ __align__(16) unsigned int cnt[];
  __shared__ int doff[13];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = (13 + DG - 1) / DG;
  const int cl = blockIdx.x / C;
  const int b = cl / groups;
  const int a0 = (cl - b * groups) * DG;
  const int nd = min(DG, 13 - a0);  // this cluster's directions
  const int n2 = ng * ng;
  const int cells = nd * n2;
  // the counts as uint4 vectors of 8 (NARROW) or 4 cells
  const int nvec = NARROW ? (cells + 7) / 8 : (cells + 3) / 4;
  unsigned char* stage = reinterpret_cast<unsigned char*>(cnt + 4 * nvec);
  const int mask = nyx_swizzle_mask(ng, NARROW);
  const int rw = NARROW ? ng / 2 : ng;
  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x)
    c4[k] = make_uint4(0u, 0u, 0u, 0u);

  const int d = min(depths[static_cast<size_t>(b) * ds], D);
  const int h = min(heights[static_cast<size_t>(b) * hs], H);
  const int w = min(widths[static_cast<size_t>(b) * ws], W);
  const size_t HW = static_cast<size_t>(H) * W;
  const int* lb = lev + static_cast<size_t>(b) * D * HW;
  const int nby = h > 0 ? (h + Yb - 1) / Yb : 0;
  const int nbr = w > 0 ? (d + Zb - 1) / Zb * nby : 0;
  const int SX = w + 2 * o;
  __syncthreads();  // counts zeroed
  for (int br = rank; br < nbr; br += C) {  // uniform over the block
    const int z0 = (br / nby) * Zb;
    const int y0 = (br - (br / nby) * nby) * Yb;
    const int zc = min(Zb, d - z0);
    const int yc = min(Yb, h - y0);
    const int SY = yc + 2 * o;
    const int SZ = zc + 2 * o;
    // the brick with its halo: 8-bit levels, 0 outside 1..ng or the cube.
    // The stage is zeroed, then each in-cube row's w levels are read four
    // at a time (16-byte loads where the bucket's rows allow, several in
    // flight a thread: the stage is latency-bound)
    const int ns = SZ * SY * SX;
    uint4* s4 = reinterpret_cast<uint4*>(stage);
    for (int k = threadIdx.x; k < (ns + 15) / 16; k += blockDim.x)
      s4[k] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    const int chunks = (w + 3) / 4;
    const int zlo = max(0, o - z0), zhi = min(SZ, d - z0 + o);
    const int ylo = max(0, o - y0), yhi = min(SY, h - y0 + o);
    const int ny = yhi - ylo;
    const int nload = max(0, zhi - zlo) * max(0, ny) * chunks;
    const bool v4 = (W & 3) == 0;
#pragma unroll 4
    for (int k = threadIdx.x; k < nload; k += blockDim.x) {
      const int row = k / chunks;
      const int x = (k - row * chunks) * 4;
      const int sz = zlo + row / ny;
      const int sy = ylo + (row - (row / ny) * ny);
      const int* src = lb + static_cast<size_t>(z0 - o + sz) * HW +
                       static_cast<size_t>(y0 - o + sy) * W + x;
      int v[4];
      if (v4) {
        const int4 q = *reinterpret_cast<const int4*>(src);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = x + u < W ? src[u] : 0;
      }
      unsigned char* dst = stage + (sz * SY + sy) * SX + o + x;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (x + u < w)
          dst[u] = static_cast<unsigned char>(v[u] >= 1 && v[u] <= ng ? v[u]
                                                                      : 0);
    }
    if (threadIdx.x < nd)  // the directions' steps in the stage
      doff[threadIdx.x] = (dirs.dz[a0 + threadIdx.x] * SY +
                           dirs.dy[a0 + threadIdx.x]) * SX +
                          dirs.dx[a0 + threadIdx.x];
    __syncthreads();
    // for each direction, a thread walks segments of NYX_GLCM3_RUN voxels
    // along x, carrying the cell it counts and its run in registers: a run
    // of one cell (the background, a uniform region) costs one atomic
    const int segs = (w + NYX_GLCM3_RUN - 1) / NYX_GLCM3_RUN;
    const int items = zc * yc * segs;
    for (int t = 0; t <= symmetric; ++t) {  // t = 1: the transposed cells
      for (int a = 0; a < nd; ++a) {
        int cur = -1, curw = 0;
        unsigned int run = 0u;
        for (int it = threadIdx.x; it < items; it += blockDim.x) {
          const int zy = it / segs;
          const int x0 = (it - zy * segs) * NYX_GLCM3_RUN;
          const int zz = zy / yc;
          const int yy = zy - zz * yc;
          const int n = min(NYX_GLCM3_RUN, w - x0);
          const int p0 = ((zz + o) * SY + yy + o) * SX + x0 + o;
          // the segment's levels first, their loads in flight together
          int cs[NYX_GLCM3_RUN], ns[NYX_GLCM3_RUN];
          const int pn = p0 + doff[a];
#pragma unroll
          for (int k = 0; k < NYX_GLCM3_RUN; ++k) {
            cs[k] = k < n ? stage[p0 + k] : 0;
            ns[k] = k < n ? stage[pn + k] : 0;
          }
#pragma unroll
          for (int k = 0; k < NYX_GLCM3_RUN; ++k) {
            const int c = cs[k];
            const int nb = c ? ns[k] : 0;
            const int i = t ? c : nb;  // the cell's row level
            const int j = t ? nb : c;  // and column level
            const int key = nb ? a * n2 + (i - 1) * ng + (j - 1) : -1;
            if (k >= n) break;
            if (key != cur) {
              if (cur >= 0)
                atomicAdd(cnt + curw, NARROW ? run << ((cur & 1) << 4) : run);
              cur = key;
              curw = (key >> NARROW) ^ ((i - 1) & mask);
              run = 0u;
            }
            ++run;
          }
        }
        if (cur >= 0)
          atomicAdd(cnt + curw, NARROW ? run << ((cur & 1) << 4) : run);
      }
    }
    __syncthreads();  // before the next brick overwrites the stage
  }
  cluster.sync();  // every block's counts complete

  // this block's share of the count words, summed over the cluster (the
  // ranks' loads in flight together; 16-bit halves apart) and written once
  // at their unswizzled place
  const int nwords = NARROW ? (cells + 1) / 2 : cells;
  const int per = (nwords + C - 1) / C;
  const int w1 = min(nwords, (rank + 1) * per);
  T* ob = out + (static_cast<size_t>(b) * 13 + a0) * n2;
  for (int wd = rank * per + threadIdx.x; wd < w1; wd += blockDim.x) {
    unsigned int lo = 0u, hi = 0u;
    if (C == 1) {
      lo = NARROW ? cnt[wd] & 0xffffu : cnt[wd];
      hi = cnt[wd] >> 16;
    } else {
      unsigned int x[NYX_GLCM3_CLUSTER_MAX];
#pragma unroll
      for (int r = 0; r < NYX_GLCM3_CLUSTER_MAX; ++r)
        if (r < C) x[r] = cluster.map_shared_rank(cnt, r)[wd];
#pragma unroll
      for (int r = 0; r < NYX_GLCM3_CLUSTER_MAX; ++r) {
        if (r >= C) break;
        lo += NARROW ? x[r] & 0xffffu : x[r];
        hi += x[r] >> 16;
      }
    }
    int lw = wd;  // the word's unswizzled place
    if (mask) lw ^= ((wd / rw) % ng) & mask;
    if (NARROW) {
      ob[2 * lw] = static_cast<T>(lo);
      if (2 * lw + 1 < cells) ob[2 * lw + 1] = static_cast<T>(hi);
    } else {
      ob[lw] = static_cast<T>(lo);
    }
  }
  cluster.sync();  // no block leaves while another reads its counts
}

template <typename T, bool NARROW>
static int launch_cluster(const void* lev, const int* dd, const int* hh,
                          const int* ww, int ds, int hs, int ws, void* out,
                          int B, int D, int H, int W, int ng,
                          const NyxDirs13& dirs, int symmetric, int C, int DG,
                          int threads, int Zb, int Yb, int o, size_t smem,
                          void* stream) {
  auto kern = glcm3d_cluster_kernel<T, NARROW>;
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, smem, C, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned int>(B) * ((13 + DG - 1) / DG) * C, 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned int>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const int*>(lev), dd, hh, ww,
                         ds, hs, ws, static_cast<T*>(out), D, H, W, ng, C, DG,
                         Zb, Yb, o, dirs, symmetric);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The device-memory path

template <typename T>
static int launch_device(const void* lev, const int* dd, const int* hh,
                         const int* ww, int ds, int hs, int ws, void* out,
                         void* gcnt, int B, int D, int H, int W, int ng,
                         const NyxDirs13& dirs, int symmetric, int in_smem,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      in_smem ? sizeof(unsigned int) * static_cast<size_t>(ng) * ng : 0;
  cudaError_t e = nyx_allow_smem(glcm3d_count_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int A = D * H * W;
  dim3 grid(B, 13, (A + NYX_GLCM3_CHUNK - 1) / NYX_GLCM3_CHUNK);
  glcm3d_count_kernel<<<grid, NYX_BLOCK, smem, s>>>(
      static_cast<const int*>(lev), dd, hh, ww, ds, hs, ws,
      static_cast<unsigned int*>(gcnt), D, H, W, ng, dirs, in_smem);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(B) * 13 * ng * ng;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  glcm3d_write_kernel<T><<<static_cast<unsigned int>(blocks), NYX_BLOCK, 0, s>>>(
      static_cast<const unsigned int*>(gcnt), static_cast<T*>(out), total, ng,
      symmetric);
  return static_cast<int>(cudaGetLastError());
}

// depths, heights, widths: device int32, ROI b's at b * ds, b * hs, b * ws;
// shifts: host int[39], the 13 (dz, dy, dx) steps already scaled by the
// offset; out: [B, 13, ng, ng] of the compute dtype.  C > 0: the cluster
// path (C blocks a ROI, bricks of Zb planes x Yb rows, halo ``offset``,
// 16-bit counts when ``narrow``, smem dynamic bytes; ops/texture3d.py
// glcm3d_plan), every cell of out written, gcnt unused.  C == 0: the
// device-memory path; gcnt a zeroed int32 [B, 13, ng, ng], in_smem: a
// block counts its direction's matrix in shared memory.
extern "C" int nyx_glcm3d_cooc(const void* lev, const void* depths,
                               const void* heights, const void* widths,
                               int ds, int hs, int ws, const void* shifts,
                               void* out, void* gcnt, int B, int D, int H,
                               int W, int ng, int symmetric, int in_smem,
                               int C, int DG, int threads, int Zb, int Yb,
                               int offset, int narrow, long long smem,
                               int is_f64, void* stream) {
  NyxDirs13 dirs;
  const int* sh = static_cast<const int*>(shifts);
  for (int a = 0; a < 13; ++a) {
    dirs.dz[a] = sh[3 * a];
    dirs.dy[a] = sh[3 * a + 1];
    dirs.dx[a] = sh[3 * a + 2];
  }
  const int* dd = static_cast<const int*>(depths);
  const int* hh = static_cast<const int*>(heights);
  const int* ww = static_cast<const int*>(widths);
  if (C == 0)
    return is_f64 ? launch_device<double>(lev, dd, hh, ww, ds, hs, ws, out,
                                          gcnt, B, D, H, W, ng, dirs,
                                          symmetric, in_smem, stream)
                  : launch_device<float>(lev, dd, hh, ww, ds, hs, ws, out,
                                         gcnt, B, D, H, W, ng, dirs, symmetric,
                                         in_smem, stream);
  if (C < 0 || C > NYX_GLCM3_CLUSTER_MAX || DG < 1 || DG > 13 ||
      threads < 32 || threads > NYX_GLCM3_THREADS_MAX || threads % 32 ||
      Zb < 1 ||
      Yb < 1 || offset < 0 ||
      ng > 255 || smem < 0 || smem > 232448 ||
      static_cast<long long>(B) * 13 * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t sm = static_cast<size_t>(smem);
  if (narrow)
    return is_f64 ? launch_cluster<double, true>(lev, dd, hh, ww, ds, hs, ws,
                                                 out, B, D, H, W, ng, dirs,
                                                 symmetric, C, DG, threads, Zb, Yb, offset,
                                                 sm, stream)
                  : launch_cluster<float, true>(lev, dd, hh, ww, ds, hs, ws,
                                                out, B, D, H, W, ng, dirs,
                                                symmetric, C, DG, threads, Zb, Yb, offset,
                                                sm, stream);
  return is_f64 ? launch_cluster<double, false>(lev, dd, hh, ww, ds, hs, ws,
                                                out, B, D, H, W, ng, dirs,
                                                symmetric, C, DG, threads, Zb, Yb, offset,
                                                sm, stream)
                : launch_cluster<float, false>(lev, dd, hh, ww, ds, hs, ws,
                                               out, B, D, H, W, ng, dirs,
                                               symmetric, C, DG, threads, Zb, Yb, offset,
                                               sm, stream);
}
