// K14 glrlm3d_runs: maximal same-level runs along the 13 directions of the
// reference's 3D GLRLM, counted into a (level, run length) matrix per
// direction.
//
// Replaces nyxus_tpu/ops/texture3d.py:134 _runs3d and :157 glrlm3d_all's
// matrix build (per direction, a pointer-jumping chain length over
// log2(max dim) shifted3d copies, then a pair_hist scatter on the TPU).
// Here one thread walks one scan line: the lines of direction d = (dz, dy,
// dx) start at the voxels v of the padded [D, H, W] cube whose v - d lies
// outside it, and step by +d to the far face.  A run is a maximal stretch
// of ``valid`` voxels with equal level; it is counted at (level - 1,
// min(length, nr) - 1), levels outside 1..ng dropped (level 0 too).
//
// The start voxels of a direction are enumerated without a scan: the face
// z = 0 (or D - 1) when dz != 0, then the face y = 0 (or H - 1) of the
// remaining planes when dy != 0, then the face x = 0 (or W - 1) of the
// remaining rows when dx != 0 -- D*H*W - (D-|dz|)(H-|dy|)(W-|dx|) lines.
//
// Bound on the card: writing the B * 13 * ng * nr output values once (at
// raw 12-bit levels, B = 8 and 32^3 cubes, 54.5 MB of float32: 16.7 us),
// and the walk of the lines: a thread's steps along its line are
// dependent (the run it carries), and their reads of the level and valid
// cubes wait on L2.
//
// Design: one thread-block cluster of S <= 8 blocks per (ROI, direction,
// pass).  The cluster's shared memory holds the matrix, block r owning the
// L levels [r * L, (r + 1) * L) of the pass (L a power of two, so that a
// level's owner is a shift), as 16-bit counts when the cube holds at most
// 65535 voxels (no cell can count more runs; the halves of 32-bit words,
// added to with one atomic each) and else 32-bit: 4096 levels x 32 lengths
// is 256 KB over 4 blocks for a 32^3 cube, 4096 x 64 is 1 MB over 8 blocks
// for 64^3.  16-bit counts halve the clusters' shared memory, so that the
// 8 x 13 clusters of the 32^3 bucket all but fit the card at once (three
// waves of blocks with 32-bit counts).  Each block walks 1/S of the
// direction's lines, reading a line's voxels eight at a time so that their
// loads are in flight together, and adds every run it ends into the owning
// block's shared memory through distributed shared memory (mapa +
// red.shared::cluster); after a cluster barrier each block writes its
// levels of the output once, zeros included, in the output's type with
// 16-byte stores.  No scratch buffer, no global atomics, one launch.  A
// matrix larger than S blocks' shared memory adds a pass axis: pass p's
// cluster counts only its own S * L levels and walks the lines again
// (their reads hit L2); a level outside the pass, like a voxel off
// ``valid``, breaks the runs around it and is never counted.  The
// wrapper's ``glrlm3d_plan`` chooses S, L, P and the count width.  Counts
// are exact.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NYX_RUNS3_THREADS 256
#define NYX_RUNS3_UNROLL 8
#define NYX_CLUSTER_MAX 8

struct NyxSteps13 {
  int dz[13];
  int dy[13];
  int dx[13];
};

// cell k of the counts: 32-bit words, or (NARROW) 16-bit halves of them
template <bool NARROW>
__device__ __forceinline__ unsigned int nyx_count(const unsigned int* cnt,
                                                  int k) {
  return NARROW ? reinterpret_cast<const unsigned short*>(cnt)[k] : cnt[k];
}

template <bool NARROW>
__device__ __forceinline__ void nyx_store16(float* dst,
                                            const unsigned int* cnt, int k) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      static_cast<float>(nyx_count<NARROW>(cnt, k)),
      static_cast<float>(nyx_count<NARROW>(cnt, k + 1)),
      static_cast<float>(nyx_count<NARROW>(cnt, k + 2)),
      static_cast<float>(nyx_count<NARROW>(cnt, k + 3)));
}

template <bool NARROW>
__device__ __forceinline__ void nyx_store16(double* dst,
                                            const unsigned int* cnt, int k) {
  *reinterpret_cast<double2*>(dst) =
      make_double2(static_cast<double>(nyx_count<NARROW>(cnt, k)),
                   static_cast<double>(nyx_count<NARROW>(cnt, k + 1)));
}

template <typename T, bool NARROW>
__global__ void __launch_bounds__(NYX_RUNS3_THREADS)
    glrlm3d_runs_kernel(const int* __restrict__ lev,
                        const unsigned char* __restrict__ valid,
                        T* __restrict__ out, int D, int H, int W, int ng,
                        int nr, int S, int logL, int P, NyxSteps13 st) {
  const int L = 1 << logL;
  extern __shared__ __align__(16) unsigned int cnt[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / S;
  const int pass = c % P;
  const int b = c / P;
  const int a = blockIdx.y;
  // the levels (0-based) of this pass [plo, plo + span), of this block
  // [lo, hi)
  const int plo = pass * S * L;
  const unsigned int span = min(ng, plo + S * L) - plo;
  const int lo = min(ng, plo + rank * L);
  const int hi = min(ng, plo + (rank + 1) * L);
  const int HW = H * W;
  const size_t base = static_cast<size_t>(b) * D * HW;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  // a voxel's key: 1 + its level's place in this pass, or 0 off ``valid``
  // or outside the pass (a level never counted here breaks the runs around
  // it exactly as a voxel off ``valid`` does)
  auto key_of = [&](int q) -> int {
    const unsigned int k = static_cast<unsigned int>(lb[q] - 1 - plo);
    return vb[q] && k < span ? static_cast<int>(k) + 1 : 0;
  };

  uint4* c4 = reinterpret_cast<uint4*>(cnt);
  const int n4 = NARROW ? (L * nr + 7) / 8 : (L * nr + 3) / 4;
  for (int k = threadIdx.x; k < n4; k += blockDim.x)
    c4[k] = make_uint4(0u, 0u, 0u, 0u);
  cluster.sync();  // every block's counts zeroed (and every block running)

  const int dz = st.dz[a], dy = st.dy[a], dx = st.dx[a];
  // start faces: z, then y of the remaining planes, then x of the rest
  const int nZ = dz ? H * W : 0;
  const int zr = dz ? D - 1 : D;
  const int zlo = dz > 0 ? 1 : 0;
  const int nY = dy ? zr * W : 0;
  const int yr = dy ? H - 1 : H;
  const int ylo = dy > 0 ? 1 : 0;
  const int nX = dx ? zr * yr : 0;
  const int nlines = nZ + nY + nX;
  const int dp = dz * HW + dy * W + dx;
  // a run of ``key`` and length len ends: count it in the owner's memory
  auto emit = [&](int key, int len) {
    if (key == 0) return;
    const int k = key - 1;
    const int off = (k & (L - 1)) * nr + min(len, nr) - 1;
    const unsigned int owner = static_cast<unsigned int>(k >> logL);
    if (NARROW)  // the half of a 32-bit word: counts stay below 2^16
      nyx_red_add(nyx_mapa(cnt + (off >> 1), owner), 1u << ((off & 1) << 4));
    else
      nyx_red_add(nyx_mapa(cnt + off, owner), 1u);
  };
  int cur = 0;
  int len = 0;
  auto step = [&](int key) {
    if (key != cur) {
      emit(cur, len);
      cur = key;
      len = 0;
    }
    ++len;
  };
  for (int t = rank * blockDim.x + threadIdx.x; t < nlines;
       t += S * blockDim.x) {
    int z, y, x;
    if (t < nZ) {
      z = dz > 0 ? 0 : D - 1;
      y = t / W;
      x = t - y * W;
    } else if (t < nZ + nY) {
      const int u = t - nZ;
      z = zlo + u / W;
      y = dy > 0 ? 0 : H - 1;
      x = u - (u / W) * W;
    } else {
      const int u = t - nZ - nY;
      z = zlo + u / yr;
      y = ylo + (u - (u / yr) * yr);
      x = dx > 0 ? 0 : W - 1;
    }
    // the line's n voxels: whole steps of NYX_RUNS3_UNROLL keys (their
    // loads in flight together, no bounds tests), then the rest one by one
    int n = D + H + W;
    if (dz) n = min(n, dz > 0 ? D - z : z + 1);
    if (dy) n = min(n, dy > 0 ? H - y : y + 1);
    if (dx) n = min(n, dx > 0 ? W - x : x + 1);
    int p = z * HW + y * W + x;
    cur = 0;
    len = 0;
    int s0 = 0;
    for (; s0 + NYX_RUNS3_UNROLL <= n; s0 += NYX_RUNS3_UNROLL) {
      int key[NYX_RUNS3_UNROLL];
#pragma unroll
      for (int u = 0; u < NYX_RUNS3_UNROLL; ++u) key[u] = key_of(p + u * dp);
#pragma unroll
      for (int u = 0; u < NYX_RUNS3_UNROLL; ++u) step(key[u]);
      p += NYX_RUNS3_UNROLL * dp;
    }
    for (; s0 < n; ++s0, p += dp) step(key_of(p));
    emit(cur, len);
  }
  cluster.sync();  // every run counted; no block reads another's memory after

  // this block's levels of the output, once: a scalar head up to a 16-byte
  // boundary, 16-byte stores, a scalar tail
  const int n = (hi - lo) * nr;
  if (n <= 0) return;
  T* o = out + (static_cast<size_t>(b) * 13 + a) * ng * nr +
         static_cast<size_t>(lo) * nr;
  constexpr int V = 16 / sizeof(T);
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(o) & 15);
  const int head = min(n, mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0);
  const int nv = (n - head) / V;
  for (int k = threadIdx.x; k < head; k += blockDim.x)
    o[k] = static_cast<T>(nyx_count<NARROW>(cnt, k));
  for (int v = threadIdx.x; v < nv; v += blockDim.x)
    nyx_store16<NARROW>(o + head + v * V, cnt, head + v * V);
  for (int k = head + nv * V + threadIdx.x; k < n; k += blockDim.x)
    o[k] = static_cast<T>(nyx_count<NARROW>(cnt, k));
}

template <typename T, bool NARROW>
static int launch(const void* lev, const void* valid, void* out, int B, int D,
                  int H, int W, int ng, int nr, int S, int logL, int P,
                  const NyxSteps13& st, void* stream) {
  const long long blocks = static_cast<long long>(B) * P * S;
  if (S < 1 || S > NYX_CLUSTER_MAX || logL < 0 || logL > 16 || P < 1 ||
      (static_cast<long long>(S) << logL) * P < ng || blocks > 2147483647LL ||
      (NARROW && static_cast<long long>(D) * H * W > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cells = static_cast<size_t>(nr) << logL;
  const size_t smem = NARROW ? (cells + 7) / 8 * 16 : (cells + 3) / 4 * 16;
  cudaError_t e = nyx_allow_smem(glrlm3d_runs_kernel<T, NARROW>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks), 13, 1);
  cfg.blockDim = dim3(NYX_RUNS3_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, glrlm3d_runs_kernel<T, NARROW>,
                         static_cast<const int*>(lev),
                         static_cast<const unsigned char*>(valid),
                         static_cast<T*>(out), D, H, W, ng, nr, S, logL, P,
                         st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// steps: host int[39], the 13 (dz, dy, dx) unit steps; out: [B, 13, ng, nr]
// of the compute dtype, every cell written; S, logL, P: the cluster size,
// log2 of the levels a block owns and the passes; narrow: count in 16 bits
// (a cube of at most 65535 voxels) (ops/texture3d.py glrlm3d_plan).
extern "C" int nyx_glrlm3d_runs(const void* lev, const void* valid,
                                const void* steps, void* out, int B, int D,
                                int H, int W, int ng, int nr, int S, int logL,
                                int P, int narrow, int is_f64, void* stream) {
  NyxSteps13 st;
  const int* sh = static_cast<const int*>(steps);
  for (int a = 0; a < 13; ++a) {
    st.dz[a] = sh[3 * a];
    st.dy[a] = sh[3 * a + 1];
    st.dx[a] = sh[3 * a + 2];
  }
  if (narrow)
    return is_f64 ? launch<double, true>(lev, valid, out, B, D, H, W, ng, nr,
                                         S, logL, P, st, stream)
                  : launch<float, true>(lev, valid, out, B, D, H, W, ng, nr, S,
                                        logL, P, st, stream);
  return is_f64 ? launch<double, false>(lev, valid, out, B, D, H, W, ng, nr, S,
                                        logL, P, st, stream)
                : launch<float, false>(lev, valid, out, B, D, H, W, ng, nr, S,
                                       logL, P, st, stream);
}
