// K15 cc3d: 3D zone labels (same-level connected components under 26- or
// 6-connectivity) and, with 6-connectivity, the in-plane border distance.
//
// Replaces nyxus_tpu/ops/texture3d.py:173 cc3d_labels (a lax.while_loop of
// 26 or 6 shifted3d min-pulls until nothing changes on the TPU) and :271
// border_distance3d (the 2D cummax / cummin scans of ops/gldzm.py:35 over
// every z-plane).
//
// Labels: the connected component of valid voxels of equal level, labelled
// by its lowest raster index z*H*W + y*W + x; BIG = D*H*W off ``valid``.
// Union-find always links the larger root under the smaller one (an atomic
// min or a compare-and-swap on the root, retried when another thread
// linked it first), so a parent never exceeds its child and stays in the
// child's component, and each component's root is its lowest index: the
// JAX label.
//
// Distance (6-connectivity only; gldzm.cpp:306-352 per z-plane): 1 + the
// steps to the nearest zero level strictly left, right, above or below in
// the voxel's plane, or to the ROI's AABB margin (x = 0 / widths-1, y = 0 /
// heights-1), whichever is nearest; at least 1.  Voxels beyond the AABB
// (level 0 in GLDZM's where(aabb, lev, 0)) count as zero levels, as the JAX
// scans see them.
//
// Bound on the card: latency, not bytes (each input read once, each output
// written once: 9 bytes a voxel, 13 with the distances): the dependent
// finds and links of the union-find, and the steps of the scans.
//
// Two designs, chosen by the wrapper's plan (ops/texture3d.py cc3d_plan):
//
// The cluster path, one launch (the plan takes it with the distances: for
// the labels alone the device-memory path measured as fast): a
// thread-block cluster of C <= 16 blocks a ROI, block r owning the slab of
// Zs planes from r * Zs, so that a bucket of a few ROIs still fills the
// card.  Slabs follow raster order, so the slab's offset r * Zs * H * W
// plus a local index is the global raster index, and parents hold global
// indices: the lowest-index rule holds across the cluster.  Each block
// stages its slab and the next plane's levels and valid bytes in shared
// memory (16-byte cp.async chunks) and folds the valid bit into the levels
// (an invalid voxel's level reads INT_MIN, so a target is one compare;
// where a valid voxel has level INT_MIN the block reads the valid bit as
// well), then, after K6 (zone_cc4.cu) in 2D:
//   1. each valid voxel's parent starts at the first voxel of its
//      same-level run along x (run starts by ballot, a warp walking a range
//      of rows in 32-voxel steps);
//   2. after a cluster barrier (every block's parents set), the other
//      forward edges are united (12 of the 13 forward neighbours under
//      26-connectivity: the next row's three and the next plane's nine; 2
//      of 3 under 6), an edge skipped where the voxel before along x is in
//      the same run and its edge reaches the same run; those into the next
//      block's first plane through distributed shared memory (relaxed
//      cluster loads and stores, and atom.shared::cluster
//      compare-and-swaps of 32- or 16-bit parents);
//      a link is a compare-and-swap of the larger root to the smaller, and
//      finds split paths on the way (a non-root of this block skips to its
//      grandparent: a plain store, which no link, always on a root, can
//      meet), so the trees stay shallow without a compression pass;
//   3. after another barrier each voxel's root, found across the cluster
//      (loads only), is written to ``anc`` once, coalesced; a last
//      barrier (relaxed: nothing to order) keeps every block's parents
//      alive until no block reads them.
// Parents are 16-bit while D*H*W <= 65535 (BIG fits), else 32-bit.  With
// the distances, the parents' memory then holds them, a plane of H rows at
// the odd pitch W | 1 (a warp reading a column hits 32 banks): each entry
// 2 * d + (the level is 0), a warp a row takes the nearest zero to the left
// as an inclusive max-scan and to the right as the mirrored min-scan (K6's
// warp scans, over 32-voxel steps with a carry), then a warp a column the
// same; one coalesced write of ``dist``.
//
// The device-memory path, for the labels alone and for cubes whose slabs
// do not fit a cluster's shared memory (the 64 x 256 x 256 crop): a
// grid over every voxel of the batch, whose parallelism a cluster of at
// most 16 blocks a ROI does not reach; union-find over every voxel of
// the batch in the label buffer (parents read with __ldcg, at L2 where the
// atomics are): a launch sets parent = own index on valid voxels, a second
// unites every valid voxel with its same-level forward neighbours, a third
// compresses every path; then one block a (ROI, plane) walks rows (both
// directions) and, after a barrier, columns for the distances.
#include <cooperative_groups.h>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NYX_CC3_CLUSTER_MAX 16
#define NYX_CC3_THREADS_MAX 1024

// ---------------------------------------------------------------------------
// cluster path

// compare-and-swap of a parent in this block's shared memory, returning the
// value before it (16-bit parents by atom.shared.cas.b16)
__device__ __forceinline__ unsigned int cc3_lcas(unsigned int* a,
                                                 unsigned int cmp,
                                                 unsigned int v) {
  return atomicCAS(a, cmp, v);
}

__device__ __forceinline__ unsigned int cc3_lcas(unsigned short* a,
                                                 unsigned int cmp,
                                                 unsigned int v) {
  const unsigned int addr =
      static_cast<unsigned int>(__cvta_generic_to_shared(a));
  unsigned short old;
  asm volatile("atom.shared.cas.b16 %0, [%1], %2, %3;"
               : "=h"(old)
               : "r"(addr), "h"(static_cast<unsigned short>(cmp)),
                 "h"(static_cast<unsigned short>(v))
               : "memory");
  return old;
}

// The cluster's parents, global index x living in block x / sv (sv the
// voxels of a full slab) at the same offset of its shared memory as
// ``par``: this block's own n voxels from global index g0 are read and
// swapped in place, the others at their shared::cluster address.
template <typename P>
struct Cc3Parents {
  P* par;
  unsigned int g0, n, sv;

  __device__ __forceinline__ unsigned int remote(unsigned int x) const {
    const unsigned int r = x / sv;
    return nyx_mapa(par, r) +
           (x - r * sv) * static_cast<unsigned int>(sizeof(P));
  }

  __device__ __forceinline__ unsigned int load(unsigned int x) const {
    const unsigned int o = x - g0;
    if (o < n) return reinterpret_cast<volatile P*>(par)[o];
    if constexpr (sizeof(P) == 2)
      return nyx_ld_cluster16(remote(x));
    else
      return nyx_ld_cluster32(remote(x));
  }

  __device__ __forceinline__ unsigned int cas(unsigned int x,
                                              unsigned int cmp,
                                              unsigned int v) const {
    const unsigned int o = x - g0;
    if (o < n) return cc3_lcas(par + o, cmp, v);
    if constexpr (sizeof(P) == 2)
      return nyx_atom_cas16_cluster(remote(x), static_cast<unsigned short>(cmp),
                                    static_cast<unsigned short>(v));
    else
      return nyx_atom_cas_cluster(remote(x), cmp, v);
  }

  __device__ __forceinline__ void store(unsigned int x, unsigned int v) const {
    const unsigned int o = x - g0;
    if (o < n)
      reinterpret_cast<volatile P*>(par)[o] = static_cast<P>(v);
    else if constexpr (sizeof(P) == 2)
      nyx_st_cluster16(remote(x), static_cast<unsigned short>(v));
    else
      nyx_st_cluster32(remote(x), v);
  }

  // the root of x; with SPLIT each voxel on the way skips to its
  // grandparent (path splitting: only non-roots are written, which no
  // link's compare-and-swap, always on a root, can meet)
  template <bool SPLIT = true>
  __device__ unsigned int find(unsigned int x) const {
    unsigned int cur = load(x);
    if (cur == x) return x;
    unsigned int prev = x, next;
    while (cur > (next = load(cur))) {
      if (SPLIT) store(prev, next);
      prev = cur;
      cur = next;
    }
    return cur;
  }

  // link the larger root under the smaller, retried where another thread
  // linked it first
  __device__ void unite(unsigned int a, unsigned int b) const {
    a = find(a);
    b = find(b);
    while (a != b) {
      if (a > b) {
        const unsigned int s = a;
        a = b;
        b = s;
      }
      const unsigned int old = cas(b, b, a);
      if (old == b) return;
      b = find(old);
      a = find(a);
    }
  }
};

// Staged voxel j takes part with level c: after the fold (cc3d_cluster_kernel)
// an invalid voxel's level reads CC3_OFF, so one compare decides where no
// valid voxel of the block has level CC3_OFF (``fast``); else the valid bit
// (bit 0 of vs) is read too.
#define CC3_OFF (-2147483647 - 1)

__device__ __forceinline__ bool cc3_same(const int* ls,
                                         const unsigned char* vs, int j,
                                         int c, bool fast) {
  return ls[j] == c && (fast || (vs[j] & 1));
}

// The forward edges of valid staged voxel i (row y, column x) to unite, as
// bits r * 3 + dx + 1 over the rows r (0: the next row; 1, 2, 3: the next
// plane's rows y - 1, y, y + 1 when ``next``, its row y alone under
// 6-connectivity) and dx in -1..1 (0 alone under 6): a target of the same
// level, skipped where the voxel before i along x is in i's run and reaches
// the target's run along the same row.
__device__ __forceinline__ unsigned int cc3_targets(
    const int* ls, const unsigned char* vs, int i, int y, int x, int H,
    int W, int HW, bool next, bool conn26, bool fast) {
  const int c = ls[i];
  const bool run = x > 0 && cc3_same(ls, vs, i - 1, c, fast);
  unsigned int m = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int dz = r > 0;
    const int dy = r == 1 ? -1 : (r == 2 ? 0 : 1);
    if (dz && !next) break;
    if (!conn26 && (r & 1)) continue;
    if (y + dy < 0 || y + dy >= H) continue;
    const int u = i + dz * HW + dy * W;
    const bool tc = cc3_same(ls, vs, u, c, fast);
    const bool tl = x > 0 && cc3_same(ls, vs, u - 1, c, fast);
    if (!conn26) {
      if (tc && !(run && tl)) m |= 2u << (3 * r);
      continue;
    }
    const bool tr = x + 1 < W && cc3_same(ls, vs, u + 1, c, fast);
    if (!run) {
      if (tl) m |= 1u << (3 * r);
      if (tc && !tl) m |= 2u << (3 * r);
    }
    if (tr && !tc) m |= 4u << (3 * r);
  }
  return m;
}

// n / d for n, d <= 65536 (a slab's voxels and rows, a row, a plane's
// rows), as n times the magic ceil(2^32 / d) (cc3_magic) over 2^32, exact
// there
__device__ __forceinline__ unsigned long long cc3_magic(unsigned int d) {
  return (0x100000000ull + d - 1) / d;
}

__device__ __forceinline__ int cc3_div(int n, unsigned long long magic) {
  return static_cast<int>(
      (static_cast<unsigned long long>(static_cast<unsigned int>(n)) * magic) >>
      32);
}

// One line of n entries at stride ``step`` of the distance tile d (2 * d +
// zero flag), a warp: the nearest zero strictly before (d = min(d, i - z,
// i); ``first``: d not read yet) and strictly after (d = min(d, z - i, m1 -
// i); ``last``: the final d + 1, at least 1, without the flag)
__device__ __forceinline__ void cc3_line_scans(int* d, int n, int step,
                                               int m1, bool first, bool last,
                                               int lane) {
  const int NEG = -(1 << 30);
  const int POS = 1 << 30;
  int carry = NEG;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    const int v = in ? d[i * step] : 0;
    int z = nyx_scan_max(in && (v & 1) ? i : NEG, lane);
    z = max(z, carry);
    int ex = __shfl_up_sync(NYX_FULL, z, 1);
    if (lane == 0) ex = carry;
    if (in) {
      int e = min(i - ex, i);
      if (!first) e = min(e, v >> 1);
      d[i * step] = 2 * e + (v & 1);
    }
    carry = __shfl_sync(NYX_FULL, z, 31);
  }
  carry = POS;
  for (int i0 = (n - 1) & ~31; i0 >= 0; i0 -= 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    const int v = in ? d[i * step] : 0;
    int z = nyx_scan_min_rev(in && (v & 1) ? i : POS, lane);
    z = min(z, carry);
    int ex = __shfl_down_sync(NYX_FULL, z, 1);
    if (lane == 31) ex = carry;
    if (in) {
      const int e = min(v >> 1, min(ex - i, m1 - i));
      d[i * step] = last ? max(e + 1, 1) : 2 * e + (v & 1);
    }
    carry = __shfl_sync(NYX_FULL, z, 0);
  }
}

// shared memory: [(Zs + 1) H W] int32 levels, [(Zs + 1) H W] valid bytes
// (each rounded up to 16 bytes), then the parents or, with the distances
// after the labels, the distance tiles (ops/texture3d.py cc3d_smem)
template <typename P>
__global__ void __launch_bounds__(NYX_CC3_THREADS_MAX)
    cc3d_cluster_kernel(const int* __restrict__ lev,
                        const unsigned char* __restrict__ valid,
                        const int* __restrict__ heights,
                        const int* __restrict__ widths, int hs, int ws,
                        int* __restrict__ anc, int* __restrict__ dist, int D,
                        int H, int W, int Zs, int conn26) {
  extern __shared__ __align__(16) int sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int HW = H * W;
  const int A = D * HW;
  const int z0 = rank * Zs;
  const int nz = min(Zs, D - z0);  // at least 1 (the plan)
  const int halo = z0 + nz < D;   // the next block's first plane staged
  const int nv = nz * HW;
  const int ns = nv + halo * HW;
  const unsigned int g0 = static_cast<unsigned int>(z0) * HW;
  const unsigned int sv = static_cast<unsigned int>(Zs) * HW;
  const int staged = (Zs + 1) * HW;
  int* ls = sm;
  unsigned char* vs = reinterpret_cast<unsigned char*>(sm) +
                      (static_cast<size_t>(staged) * 4 + 15) / 16 * 16;
  P* par = reinterpret_cast<P*>(vs + (staged + 15) / 16 * 16);
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const size_t rb = static_cast<size_t>(b) * A + g0;
  {  // stage: 16-byte chunks where the source allows, then the tail
    const int* lsrc = lev + rb;
    const unsigned char* vsrc = valid + rb;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(lsrc) & 15) == 0) {
      head = ns & ~3;
      for (int k = 4 * t; k < head; k += 4 * T) nyx_cp16(ls + k, lsrc + k);
    }
    for (int k = head + t; k < ns; k += T) nyx_cp4(ls + k, lsrc + k);
    head = 0;
    if ((reinterpret_cast<uintptr_t>(vsrc) & 15) == 0) {
      head = ns & ~15;
      for (int k = 16 * t; k < head; k += 16 * T) nyx_cp16(vs + k, vsrc + k);
    }
    for (int k = head + t; k < ns; k += T) vs[k] = vsrc[k];
    nyx_cp_wait();
  }
  __syncthreads();
  // the fold: vs holds the valid bit and, in bit 1, the level-0 bit (the
  // distances'); an invalid voxel's level becomes CC3_OFF
  bool slow = false;
  for (int k = t; k < ns; k += T) {
    const bool v = vs[k] != 0;
    const int l = ls[k];
    vs[k] = static_cast<unsigned char>(v | ((l == 0) << 1));
    if (!v) ls[k] = CC3_OFF;
    slow |= v && l == CC3_OFF;
  }
  const bool fast = !__syncthreads_or(slow);
  const unsigned long long mW = cc3_magic(W);
  const unsigned long long mH = cc3_magic(H);
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = T >> 5;
  {  // 1. parents: the first voxel of each run along x
    const int nrows = nz * H;
    const int per = (nrows + nw - 1) / nw;
    const int end = min(nrows, (warp + 1) * per) * W;
    int carry = 0;
    for (int i0 = warp * per * W; i0 < end; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < end;
      const bool v = in && (vs[i] & 1);
      const int x = i - cc3_div(i, mW) * W;
      const bool same = v && x > 0 && cc3_same(ls, vs, i - 1, ls[i], fast);
      const unsigned int upto =
          __ballot_sync(NYX_FULL, !same) & (NYX_FULL >> (31 - lane));
      const int s = upto ? i0 + 31 - __clz(upto) : carry;
      if (v) par[i] = static_cast<P>(g0 + s);
      carry = __shfl_sync(NYX_FULL, s, 31);
    }
  }
  // 2. every forward edge, inside the slab and into the next block's first
  // plane, once each block's parents are set
  cluster.sync();
  const Cc3Parents<P> pr{par, g0, static_cast<unsigned int>(nv), sv};
  const bool c26 = conn26 != 0;
  for (int i = t; i < nv; i += T) {
    if (!(vs[i] & 1)) continue;
    const int row = cc3_div(i, mW);  // z * H + y
    const int z = cc3_div(row, mH);
    unsigned int m = cc3_targets(ls, vs, i, row - z * H, i - row * W, H, W,
                                 HW, z + 1 < nz || halo, c26, fast);
    while (m) {
      const int k = __ffs(m) - 1;
      m &= m - 1;
      const int r = k / 3;
      const int u = i + (r ? HW : 0) + (r == 1 ? -W : (r == 2 ? 0 : W)) +
                    k - 3 * r - 1;
      pr.unite(g0 + i, g0 + u);
    }
  }
  cluster.sync();
  // 3. roots, once
  for (int i = t; i < nv; i += T)
    anc[rb + i] = (vs[i] & 1)
                      ? static_cast<int>(pr.template find<false>(g0 + i))
                      : A;
  // every block's finds (loads only) done before any block leaves or
  // reuses its parents' memory: no memory to order
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
  if (dist == nullptr) return;
  // distances, a plane of [H][W | 1] entries each, in the parents' memory
  const int PD = W | 1;
  int* dt = reinterpret_cast<int*>(par);
  for (int i = t; i < nv; i += T) {
    const int zy = cc3_div(i, mW);
    dt[zy * PD + i - zy * W] = vs[i] >> 1;
  }
  __syncthreads();
  const int w1 = widths[static_cast<size_t>(b) * ws] - 1;
  const int h1 = heights[static_cast<size_t>(b) * hs] - 1;
  for (int line = warp; line < nz * H; line += nw)
    cc3_line_scans(dt + line * PD, W, 1, w1, true, false, lane);
  __syncthreads();
  for (int line = warp; line < nz * W; line += nw) {
    const int z = cc3_div(line, mW);
    cc3_line_scans(dt + z * H * PD + line - z * W, H, PD, h1, false, true,
                   lane);
  }
  __syncthreads();
  for (int i = t; i < nv; i += T) {
    const int zy = cc3_div(i, mW);
    dist[rb + i] = dt[zy * PD + i - zy * W];
  }
}

template <typename P>
static int cc3_cluster_launch(const void* lev, const void* valid,
                              const void* heights, const void* widths, int hs,
                              int ws, void* anc, void* dist, int B, int D,
                              int H, int W, int conn26, int C, int Zs, int T,
                              size_t smem, cudaStream_t st) {
  auto kern = cc3d_cluster_kernel<P>;
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, smem, C, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * C, 1, 1);
  cfg.blockDim = dim3(T, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const int*>(lev),
                         static_cast<const unsigned char*>(valid),
                         static_cast<const int*>(heights),
                         static_cast<const int*>(widths), hs, ws,
                         static_cast<int*>(anc), static_cast<int*>(dist), D,
                         H, W, Zs, conn26);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// device-memory path

__device__ __forceinline__ int nyx_find3(int* par, int x) {
  int p = __ldcg(par + x);
  while (p != x) {
    x = p;
    p = __ldcg(par + x);
  }
  return x;
}

__device__ void nyx_unite3(int* par, int a, int b) {
  a = nyx_find3(par, a);
  b = nyx_find3(par, b);
  while (a != b) {
    if (a > b) {
      const int s = a;
      a = b;
      b = s;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = nyx_find3(par, old);
    a = nyx_find3(par, a);
  }
}

__global__ void cc3d_init_kernel(const unsigned char* __restrict__ valid,
                                 int* __restrict__ anc, long long total,
                                 int A) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    anc[t] = valid[t] ? p : A;
  }
}

__global__ void cc3d_union_kernel(const int* __restrict__ lev,
                                  const unsigned char* __restrict__ valid,
                                  int* __restrict__ anc, long long total,
                                  int D, int H, int W, int conn26) {
  const int HW = H * W;
  const int A = D * HW;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!valid[t]) continue;
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    const size_t base = static_cast<size_t>(b) * A;
    const int* lb = lev + base;
    const unsigned char* vb = valid + base;
    int* par = anc + base;
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    const int l = lb[p];
    // forward neighbours: (0, 0, +1), (0, +1, -1..1), (+1, -1..1, -1..1)
    // under 26-connectivity; (0, 0, +1), (0, +1, 0), (+1, 0, 0) under 6
    for (int dz = 0; dz <= 1; ++dz) {
      for (int dy = (dz ? -1 : 0); dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          if (dz == 0 && dy == 0 && dx <= 0) continue;
          if (!conn26 && (dz != 0) + (dy != 0) + (dx != 0) != 1) continue;
          if (!conn26 && dx < 0) continue;
          const int nz = z + dz, ny = y + dy, nx = x + dx;
          if (nz >= D || ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
          const int q = nz * HW + ny * W + nx;
          if (vb[q] && lb[q] == l) nyx_unite3(par, p, q);
        }
      }
    }
  }
}

__global__ void cc3d_compress_kernel(const unsigned char* __restrict__ valid,
                                     int* __restrict__ anc, long long total,
                                     int A) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!valid[t]) continue;
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    int* par = anc + static_cast<size_t>(b) * A;
    par[p] = nyx_find3(par, p);
  }
}

__global__ void cc3d_dist_kernel(const int* __restrict__ lev,
                                 const int* __restrict__ heights,
                                 const int* __restrict__ widths, int hs,
                                 int ws, int* __restrict__ dist, int D, int H,
                                 int W) {
  const int b = blockIdx.x / D;  // one block a (ROI, z-plane)
  const size_t base = static_cast<size_t>(blockIdx.x) * H * W;
  const int* lb = lev + base;
  int* db = dist + base;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int NEG = -(1 << 30);
  const int POS = 1 << 30;
  const int w1 = widths[static_cast<size_t>(b) * ws] - 1;
  const int h1 = heights[static_cast<size_t>(b) * hs] - 1;
  for (int y = t; y < H; y += T) {
    const int* lr = lb + y * W;
    int* dr = db + y * W;
    int z = NEG;  // nearest zero strictly left
    for (int x = 0; x < W; ++x) {
      dr[x] = min(x - z, x);
      if (lr[x] == 0) z = x;
    }
    z = POS;      // nearest zero strictly right
    for (int x = W - 1; x >= 0; --x) {
      dr[x] = min(dr[x], min(z - x, w1 - x));
      if (lr[x] == 0) z = x;
    }
  }
  __syncthreads();
  for (int x = t; x < W; x += T) {
    int z = NEG;  // nearest zero strictly above
    for (int y = 0; y < H; ++y) {
      const int p = y * W + x;
      db[p] = min(db[p], min(y - z, y));
      if (lb[p] == 0) z = y;
    }
    z = POS;      // nearest zero strictly below
    for (int y = H - 1; y >= 0; --y) {
      const int p = y * W + x;
      db[p] = max(min(db[p], min(z - y, h1 - y)) + 1, 1);
      if (lb[p] == 0) z = y;
    }
  }
}

// conn26: 1 for 26-connectivity, 0 for 6; dist (6 only, else NULL) with
// heights and widths the ROIs' AABB sizes at strides hs and ws.  C = 0: the
// device-memory path; else the cluster path, clusters of C blocks of T
// threads over slabs of Zs planes, ``wide`` 32-bit parents, ``smem`` bytes
// of shared memory (ops/texture3d.py cc3d_plan).
extern "C" int nyx_cc3d(const void* lev, const void* valid,
                        const void* heights, const void* widths, int hs,
                        int ws, void* anc, void* dist, int B, int D, int H,
                        int W, int conn26, int C, int Zs, int T, int wide,
                        int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int A = D * H * W;
  if (C > 0) {
    const long long staged = static_cast<long long>(Zs + 1) * H * W;
    const long long pars = static_cast<long long>(Zs) * H * W * (wide ? 4 : 2);
    const long long tiles =
        dist ? static_cast<long long>(Zs) * H * (W | 1) * 4 : 0;
    const long long need = (staged * 4 + 15) / 16 * 16 +
                           (staged + 15) / 16 * 16 +
                           (pars > tiles ? pars : tiles);
    if (C > NYX_CC3_CLUSTER_MAX || Zs < 1 || (C - 1) * Zs >= D ||
        C * Zs < D || T < 32 || T > NYX_CC3_THREADS_MAX || T % 32 ||
        smem < need || (!wide && A > 65535) ||
        static_cast<long long>(B) * C > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
    return wide ? cc3_cluster_launch<unsigned int>(lev, valid, heights, widths,
                                                   hs, ws, anc, dist, B, D, H,
                                                   W, conn26, C, Zs, T, smem, s)
                : cc3_cluster_launch<unsigned short>(
                      lev, valid, heights, widths, hs, ws, anc, dist, B, D, H,
                      W, conn26, C, Zs, T, smem, s);
  }
  const long long total = static_cast<long long>(B) * A;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  const unsigned int nb = static_cast<unsigned int>(blocks);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  int* a = static_cast<int*>(anc);
  cc3d_init_kernel<<<nb, NYX_BLOCK, 0, s>>>(v, a, total, A);
  cc3d_union_kernel<<<nb, NYX_BLOCK, 0, s>>>(static_cast<const int*>(lev), v,
                                             a, total, D, H, W, conn26);
  cc3d_compress_kernel<<<nb, NYX_BLOCK, 0, s>>>(v, a, total, A);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || dist == nullptr) return static_cast<int>(e);
  cc3d_dist_kernel<<<static_cast<unsigned int>(B) * D, NYX_BLOCK, 0, s>>>(
      static_cast<const int*>(lev), static_cast<const int*>(heights),
      static_cast<const int*>(widths), hs, ws, static_cast<int*>(dist), D, H,
      W);
  return static_cast<int>(cudaGetLastError());
}
