// K4 neigh_matrix: the whole matrix of one 8-neighbour texture family in one
// launch, from the family's levels and participation.
//
// Replaces the shifted2d neighbour loops and the histograms of
// nyxus_tpu/ops/gldm.py:27 gldm_matrix (loop :31-35),
// nyxus_tpu/ops/ngldm.py:41-46 and nyxus_tpu/ops/ngtdm.py:37-46 (eight padded
// copies of the crop, then masked_bincount / pair_hist on the TPU).  Over the
// neighbours of ops/common.py NEIGHBORS8 (pixels outside the crop do not take
// part), for each ROI b:
//   GLDM   participation orig > 0; same = participating neighbours with the
//          centre's level; P[b, lev - 1, same] += 1 for participating
//          centres, levels outside 1..nbins adding nothing: [B, nbins, 9]
//   NGLDM  participation the ROI mask; matches as GLDM's same;
//          P[b, lev, matches] += 1 for participating centres with a level in
//          0..nbins - 1: [B, nbins, 9]
//   NGTDM  participation `valid` (levels read as 0 outside it); nsum / ncnt
//          over participating neighbours with level > 0, ave = nsum /
//          max(ncnt, 1) in the compute type; over the centre's level (in
//          0..nbins - 1): N += is_zone (level > 0 and ncnt > 0), S += is_zone
//          * |level - ave|, cnt += valid; present = cnt > 0, bin 0 false:
//          N and S [2, B, nbins] and present [B, nbins]
// The matrices hold counts, written from 32-bit integers, so GLDM's and
// NGLDM's P and NGTDM's N and present equal the plain version's; NGTDM's S
// adds the same terms in another order (a match group's terms in lane order,
// the groups by shared atomics), within 2 n u sum(w) of a cell of n terms.
//
// Design (ops/common.py neigh_matrix_plan picks the path):
// - "smem": one block a ROI.  The crop is staged once in shared memory as
//   16-bit codes, the level and the participation folded into one value
//   and a ring of 0 (no participation) around the crop, read with 16-byte
//   loads of the levels where the rows allow (a matrix of 65535 levels or
//   more never fits a block, so a staged matrix's codes fit 16 bits; NGTDM
//   marks a level past them and reads it again from the levels).  A thread
//   a pixel then reads its 8 neighbours from shared memory with no bounds
//   tests.  The family's counts sit in shared memory as 32-bit integers
//   (NGTDM: a level's cnt and N side by side, and S in the compute type).
// - "cluster": a thread-block cluster of C <= 16 blocks a ROI, block r
//   staging rows [r R, r R + R) with one row of halo each side and counting
//   them into its own copy of the counts; after a cluster barrier block r
//   sums its share of the cells over the C copies through distributed
//   shared memory and writes them (crops past 2048 pixels: 64², the long
//   ROI's 1024 x 64).
// - "device": the crop is read from device memory and the counts sit in a
//   device scratch, zeroed by the block that owns the ROI (ROIs whose
//   matrix and rows pass a block's shared memory even over 16 blocks).
// Updates are warp-aggregated: __match_any_sync on the cell (NGTDM: the
// level), and the group's lowest lane adds the group's count with one
// atomic (NGTDM: cnt and, for the group's zone pixels, N and the sum of
// their terms |level - ave| in lane order; a 64-bit shared atomic add of
// the two counts ran slower than two 32-bit ones), so a uniform ROI sends one
// atomic a warp, not one a pixel.  Each cell is written once, converted to
// the compute type: no zeroing launch, no K1 launch.  Bound on the card:
// bytes (4 of level and 1-8 of participation read a pixel, the matrix
// written once); at the main buckets a launch and one round of loads.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

#define NM_GLDM 0
#define NM_NGLDM 1
#define NM_NGTDM 2
#define NM_ND 9  // dependence columns: 0..8 neighbours
#define NM_THREADS_MAX 1024

// participation: 0/1 bytes, or a float32 / float64 crop read as v > 0
#define NM_PART_U8 0
#define NM_PART_F32 1
#define NM_PART_F64 2

__device__ __forceinline__ bool nm_part(const void* part, int kind,
                                        long long i) {
  if (kind == NM_PART_U8)
    return static_cast<const unsigned char*>(part)[i] != 0;
  if (kind == NM_PART_F32) return static_cast<const float*>(part)[i] > 0.f;
  return static_cast<const double*>(part)[i] > 0.0;
}

// A pixel's code: 0 where it does not take part; else GLDM its level (0 where
// the level lies outside 1..nbins: it can match no counted centre), NGLDM
// its level + 1 (0 outside 0..nbins - 1), NGTDM its level + 1 (0 for a
// negative level, which neither counts nor is counted), capped at cmax, the
// mark of a level whose code does not fit (read again from the levels).
template <int MODE>
__device__ __forceinline__ unsigned int nm_code(int lev, bool part, int nbins,
                                                unsigned int cmax) {
  if (!part) return 0u;
  if (MODE == NM_GLDM)
    return lev >= 1 && lev <= nbins ? static_cast<unsigned int>(lev) : 0u;
  if (MODE == NM_NGLDM)
    return lev >= 0 && lev < nbins ? static_cast<unsigned int>(lev) + 1u : 0u;
  if (lev < 0) return 0u;
  const unsigned int c = static_cast<unsigned int>(lev) + 1u;
  return c < cmax ? c : cmax;
}

__host__ __device__ __forceinline__ size_t nm_align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

namespace cg = cooperative_groups;

#define NM_PATH_SMEM 0
#define NM_PATH_CLUSTER 1
#define NM_PATH_DEVICE 2
#define NM_CLUSTER_MAX 16

// two blocks of NM_THREADS_MAX an SM (32 registers a thread): a slide's 300
// crops of 32² take one wave of the 132 SMs, not three
template <int MODE, typename T, int PATH>
__global__ void __launch_bounds__(NM_THREADS_MAX, 2)
    neigh_matrix_kernel(const int* __restrict__ lev,
                        const void* __restrict__ part, int kind,
                        T* __restrict__ out, bool* __restrict__ present,
                        void* __restrict__ dcount, T* __restrict__ dsum, int B,
                        int H, int W, int nbins, int R, int vec) {
  extern __shared__ __align__(16) unsigned char nm_smem[];
  constexpr bool STAGED = PATH != NM_PATH_DEVICE;
  // the staged codes and the code marking a level past them (NGTDM)
  using C = typename std::conditional<STAGED, unsigned short,
                                      unsigned int>::type;
  constexpr unsigned int CMAX = STAGED ? 0xFFFFu : 0xFFFFFFFFu;
  const int DX[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  const int DY[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  // this block's ROI, its rank in the cluster and its rows [y0, y1)
  int b = blockIdx.x, rank = 0, nblk = 1;
  if constexpr (PATH == NM_PATH_CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    nblk = static_cast<int>(cg::this_cluster().num_blocks());
    b = blockIdx.x / nblk;
  }
  const int y0 = rank * R;
  const int y1 = min(H, y0 + R);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long base = static_cast<long long>(b) * H * W;
  const int* lb = lev + base;
  // GLDM / NGLDM: [nbins, 9] counts; NGTDM: a (cnt, N) pair a level
  const int ncell = MODE == NM_NGTDM ? nbins : NM_ND * nbins;

  unsigned int* count = nullptr;  // NGTDM: the pairs
  T* ssum = nullptr;
  T* scratch = nullptr;
  C* code = nullptr;
  size_t off = 0;
  const int nword = MODE == NM_NGTDM ? 2 * nbins : ncell;
  if constexpr (STAGED) {
    count = reinterpret_cast<unsigned int*>(nm_smem);
    off = nm_align16(sizeof(unsigned int) * nword);
    if (MODE == NM_NGTDM) {
      ssum = reinterpret_cast<T*>(nm_smem + off);
      off += nm_align16(sizeof(T) * nbins);
    }
  } else {
    count = static_cast<unsigned int*>(dcount) + static_cast<size_t>(b) * nword;
    if (MODE == NM_NGTDM) ssum = dsum + static_cast<size_t>(b) * nbins;
  }
  if (MODE == NM_NGTDM) {
    scratch = reinterpret_cast<T*>(nm_smem + off) + 32 * warp;
    off += nm_align16(sizeof(T) * 32 * (nt >> 5));
  }
  const int Wp = W + 2;
  if constexpr (STAGED) {
    // local row j holds crop row y0 - 1 + j, j in [0, y1 - y0 + 2)
    code = reinterpret_cast<C*>(nm_smem + off);
    const int LR = y1 - y0 + 2;
    for (int j = tid; j < LR; j += nt) {
      code[j * Wp] = 0;
      code[j * Wp + W + 1] = 0;
    }
    if (y0 == 0)
      for (int x = tid; x < W; x += nt) code[x + 1] = 0;
    if (y1 == H)
      for (int x = tid; x < W; x += nt) code[(LR - 1) * Wp + x + 1] = 0;
    const int qa = max(0, y0 - 1) * W, qb = min(H, y1 + 1) * W;
    if (vec) {
      // W % 4 == 0 and aligned rows: 4 pixels of one row a step, the levels
      // as one 16-byte load
      for (int q = qa + 4 * tid; q < qb; q += 4 * nt) {
        const int4 l = *reinterpret_cast<const int4*>(lb + q);
        bool p[4];
        if (kind == NM_PART_U8) {
          const unsigned int u = *reinterpret_cast<const unsigned int*>(
              static_cast<const unsigned char*>(part) + base + q);
#pragma unroll
          for (int k = 0; k < 4; ++k) p[k] = ((u >> (8 * k)) & 0xFFu) != 0;
        } else if (kind == NM_PART_F32) {
          const float4 u = *reinterpret_cast<const float4*>(
              static_cast<const float*>(part) + base + q);
          p[0] = u.x > 0.f; p[1] = u.y > 0.f; p[2] = u.z > 0.f; p[3] = u.w > 0.f;
        } else {
          const double2* d = reinterpret_cast<const double2*>(
              static_cast<const double*>(part) + base + q);
          const double2 u0 = d[0], u1 = d[1];
          p[0] = u0.x > 0.0; p[1] = u0.y > 0.0; p[2] = u1.x > 0.0;
          p[3] = u1.y > 0.0;
        }
        const int y = q / W, x = q - y * W;
        C* dst = code + (y - y0 + 1) * Wp + x + 1;
        dst[0] = static_cast<C>(nm_code<MODE>(l.x, p[0], nbins, CMAX));
        dst[1] = static_cast<C>(nm_code<MODE>(l.y, p[1], nbins, CMAX));
        dst[2] = static_cast<C>(nm_code<MODE>(l.z, p[2], nbins, CMAX));
        dst[3] = static_cast<C>(nm_code<MODE>(l.w, p[3], nbins, CMAX));
      }
    } else {
      for (int q = qa + tid; q < qb; q += nt) {
        const int y = q / W, x = q - y * W;
        code[(y - y0 + 1) * Wp + x + 1] = static_cast<C>(
            nm_code<MODE>(lb[q], nm_part(part, kind, base + q), nbins, CMAX));
      }
    }
  }
  for (int i = tid; i < nword; i += nt) count[i] = 0u;
  if (MODE == NM_NGTDM)
    for (int i = tid; i < nbins; i += nt) ssum[i] = T(0);
  __syncthreads();

  // the code at crop position (y, x), y in [y0 - 1, y1], x in [-1, W]
  auto code_at = [&](int y, int x) -> unsigned int {
    if constexpr (STAGED) {
      return code[(y - y0 + 1) * Wp + x + 1];
    } else {
      if (y < 0 || y >= H || x < 0 || x >= W) return 0u;
      const long long i = base + static_cast<long long>(y) * W + x;
      return nm_code<MODE>(lev[i], nm_part(part, kind, i), nbins, CMAX);
    }
  };
  // the level of a pixel whose NGTDM code is c >= 1
  auto level_of = [&](unsigned int c, int y, int x) -> int {
    return c == CMAX ? lb[y * W + x] : static_cast<int>(c) - 1;
  };

  // every pixel of the block's rows: a warp-uniform trip count, so that
  // every lane reaches __match_any_sync
  {
    const int npx = (y1 - y0) * W;
    for (int p0 = 0; p0 < npx; p0 += nt) {
      const int p = p0 + tid;
      int key = -1;  // GLDM / NGLDM: the cell; NGTDM: the level
      bool zone = false;
      T diff = T(0);
      if (p < npx) {
        const int row = p / W;
        const int y = y0 + row, x = p - row * W;
        const unsigned int c = code_at(y, x);
        if (c != 0u) {
          if (MODE != NM_NGTDM) {
            int same = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k)
              same += code_at(y + DY[k], x + DX[k]) == c;
            key = static_cast<int>(c - 1u) * NM_ND + same;
          } else {
            const int l = level_of(c, y, x);
            if (l < nbins) {
              int ns = 0, nc = 0;
#pragma unroll
              for (int k = 0; k < 8; ++k) {
                const int ny = y + DY[k], nx = x + DX[k];
                const unsigned int m = code_at(ny, nx);
                if (m >= 2u) {  // participating, level > 0
                  ns += level_of(m, ny, nx);
                  ++nc;
                }
              }
              zone = l > 0 && nc > 0;
              if (zone) {
                const T ave = static_cast<T>(ns) / static_cast<T>(nc);
                diff = fabs(static_cast<T>(l) - ave);
              }
              key = l;
            }
          }
        }
      }
      const unsigned int grp = __match_any_sync(NYX_FULL, key);
      const bool leader = lane == __ffs(grp) - 1;
      if (MODE != NM_NGTDM) {
        if (key >= 0 && leader)
          atomicAdd(&count[key], static_cast<unsigned int>(__popc(grp)));
      } else {
        const unsigned int zones = grp & __ballot_sync(NYX_FULL, zone);
        scratch[lane] = diff;
        __syncwarp();
        if (key >= 0 && leader) {
          atomicAdd(&count[2 * key], static_cast<unsigned int>(__popc(grp)));
          if (zones) {
            atomicAdd(&count[2 * key + 1],
                      static_cast<unsigned int>(__popc(zones)));
            T s = T(0);
            for (unsigned int m = zones; m; m &= m - 1u)
              s += scratch[__ffs(m) - 1];
            atomicAdd(&ssum[key], s);
          }
        }
        __syncwarp();
      }
    }
  }

  // each cell written once, in the compute type: on the cluster path block
  // r sums its share of the cells over the cluster's copies (distributed
  // shared memory); the device path reads its counts past L1, where other
  // threads' atomics landed
  int c0 = 0, c1 = ncell;
  if constexpr (PATH == NM_PATH_CLUSTER) {
    cg::this_cluster().sync();
    const int per = (ncell + nblk - 1) / nblk;
    c0 = min(ncell, rank * per);
    c1 = min(ncell, c0 + per);
  } else {
    __syncthreads();
  }
  auto from = [&](auto* p, int q) {
    if constexpr (PATH == NM_PATH_CLUSTER)
      return cg::this_cluster().map_shared_rank(p, q);
    else
      return p;
  };
  if (MODE != NM_NGTDM) {
    T* o = out + static_cast<size_t>(b) * ncell;
    for (int i = c0 + tid; i < c1; i += nt) {
      unsigned int v = 0u;
      for (int q = 0; q < nblk; ++q) {
        if constexpr (STAGED) v += from(count, q)[i];
        else v += __ldcg(count + i);
      }
      o[i] = static_cast<T>(v);
    }
  } else {
    T* oN = out + static_cast<size_t>(b) * nbins;
    T* oS = out + (static_cast<size_t>(B) + b) * nbins;
    bool* pr = present + static_cast<size_t>(b) * nbins;
    for (int i = c0 + tid; i < c1; i += nt) {
      unsigned int cnt = 0u, n = 0u;
      T s = T(0);
      for (int q = 0; q < nblk; ++q) {
        uint2 w;
        if constexpr (STAGED) {
          w = reinterpret_cast<const uint2*>(from(count, q))[i];
          s += from(ssum, q)[i];
        } else {
          w = __ldcg(reinterpret_cast<const uint2*>(count) + i);
          s += __ldcg(ssum + i);
        }
        cnt += w.x;
        n += w.y;
      }
      oN[i] = static_cast<T>(n);
      oS[i] = s;
      pr[i] = i > 0 && cnt > 0u;
    }
  }
  if constexpr (PATH == NM_PATH_CLUSTER)
    cg::this_cluster().sync();  // no block leaves while others read it
}

template <int MODE, typename T, int PATH>
static int nm_launch(const void* lev, const void* part, int kind, void* out,
                     void* present, void* dcount, void* dsum, int B, int H,
                     int W, int nbins, int C, int threads, int smem, int vec,
                     cudaStream_t st) {
  auto kern = neigh_matrix_kernel<MODE, T, PATH>;
  const int R = PATH == NM_PATH_CLUSTER ? (H + C - 1) / C : H;
  if (threads < 32 || threads > NM_THREADS_MAX || threads % 32 != 0 ||
      (PATH == NM_PATH_CLUSTER && (C < 2 || C > NM_CLUSTER_MAX)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (PATH != NM_PATH_CLUSTER) {
    cudaError_t e = nyx_allow_smem(kern, static_cast<size_t>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<B, threads, smem, st>>>(
        static_cast<const int*>(lev), part, kind, static_cast<T*>(out),
        static_cast<bool*>(present), dcount, static_cast<T*>(dsum), B, H, W,
        nbins, R, vec);
    return static_cast<int>(cudaGetLastError());
  }
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, static_cast<size_t>(smem), C, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * C, 1, 1);
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
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const int*>(lev), part, kind,
                         static_cast<T*>(out), static_cast<bool*>(present),
                         dcount, static_cast<T*>(dsum), B, H, W, nbins, R,
                         vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, typename T>
static int nm_path(int path, const void* lev, const void* part, int kind,
                   void* out, void* present, void* dcount, void* dsum, int B,
                   int H, int W, int nbins, int C, int threads, int smem,
                   int vec, cudaStream_t st) {
  if (path == NM_PATH_SMEM)
    return nm_launch<MODE, T, NM_PATH_SMEM>(lev, part, kind, out, present,
                                            dcount, dsum, B, H, W, nbins, C,
                                            threads, smem, vec, st);
  if (path == NM_PATH_CLUSTER)
    return nm_launch<MODE, T, NM_PATH_CLUSTER>(lev, part, kind, out, present,
                                               dcount, dsum, B, H, W, nbins,
                                               C, threads, smem, vec, st);
  return nm_launch<MODE, T, NM_PATH_DEVICE>(lev, part, kind, out, present,
                                            dcount, dsum, B, H, W, nbins, C,
                                            threads, smem, vec, st);
}

template <typename T>
static int nm_mode(int mode, int path, const void* lev, const void* part,
                   int kind, void* out, void* present, void* dcount,
                   void* dsum, int B, int H, int W, int nbins, int C,
                   int threads, int smem, int vec, cudaStream_t st) {
  if (mode == NM_GLDM)
    return nm_path<NM_GLDM, T>(path, lev, part, kind, out, present, dcount,
                               dsum, B, H, W, nbins, C, threads, smem, vec,
                               st);
  if (mode == NM_NGLDM)
    return nm_path<NM_NGLDM, T>(path, lev, part, kind, out, present, dcount,
                                dsum, B, H, W, nbins, C, threads, smem, vec,
                                st);
  return nm_path<NM_NGTDM, T>(path, lev, part, kind, out, present, dcount,
                              dsum, B, H, W, nbins, C, threads, smem, vec, st);
}

// lev: [B, H, W] int32; part: [B, H, W] of part_kind (NM_PART_*); out:
// [B, nbins, 9] (GLDM, NGLDM) or [2, B, nbins] (NGTDM's N and S) of the
// compute type; present: [B, nbins] bytes (NGTDM); dcount / dsum: the device
// path's scratch, [B, 9 nbins] or [B, 2 nbins] (NGTDM) 32-bit counts and
// [B, nbins] of the compute type (NGTDM), else unused.  mode: NM_GLDM,
// NM_NGLDM or NM_NGTDM; path: NM_PATH_SMEM (a block a ROI), NM_PATH_CLUSTER
// (C blocks a ROI, ceil(H / C) rows each) or NM_PATH_DEVICE; smem: the
// dynamic shared memory the plan computed; vec: W % 4 == 0 and the crops
// 16-byte aligned.
extern "C" int nyx_neigh_matrix(const void* lev, const void* part,
                                int part_kind, void* out, void* present,
                                void* dcount, void* dsum, int B, int H, int W,
                                int nbins, int mode, int path, int C,
                                int threads, int smem, int vec, int is_f64,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return nm_mode<double>(mode, path, lev, part, part_kind, out, present,
                           dcount, dsum, B, H, W, nbins, C, threads, smem,
                           vec, st);
  return nm_mode<float>(mode, path, lev, part, part_kind, out, present,
                        dcount, dsum, B, H, W, nbins, C, threads, smem, vec,
                        st);
}
