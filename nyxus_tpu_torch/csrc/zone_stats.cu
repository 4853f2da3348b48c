// K7 zone_stats: per-zone grey level, size and (GLDZM) minimum distance.
//
// Replaces nyxus_tpu/ops/zones.py:140 zone_list (one lax.sort of the
// [B, A] labels with the levels and distances as payload, then run
// boundaries found by scans on the TPU).  No sort here: each zone's size
// and minimum distance are counted at the zone's label, and the level is
// read at the seed.  The output is [B, A] arrays in RASTER ORDER OF THE
// SEEDS: position p holds zone p when ``ok[p]`` (p is valid and its own
// label), and zeros elsewhere.  JAX returns the same zones in sorted-label
// order, which is the same order with the gaps squeezed out; the feature
// code only sums over zones.  A valid pixel whose label lies outside
// [0, A) is skipped.
//
// Design (ops/zones.py zone_stats_plan picks the path):
// - "smem": one block a ROI, the ROI's size counters and distance minima
//   (32-bit each) in shared memory.
// - "cluster": a thread-block cluster of C <= 16 blocks a ROI, block r
//   reading pixels [r S, r S + S) and owning the counters of the same
//   labels; a run's add and min go to the label's owner through
//   distributed shared memory (red.shared::cluster), local ones as shared
//   atomics.  Since a block reads exactly the pixels whose labels it owns,
//   it knows which of its labels are seeds.
// - "device": the first port's kernel, a block a ROI counting with L2
//   atomics in the output buffers, kept for ROIs whose counters pass a
//   cluster's shared memory (a 64 x 256 x 256 crop).
// On the first two paths a lane holds 4 consecutive pixels, read as
// 16-byte vectors of anc, lev and dist and 4 bytes of valid where A is a
// multiple of 4 and the rows are aligned, so that a warp walks 128
// consecutive pixels.  Consecutive pixels with the same label form a run
// (a run may cross rows: pixels of one label are one zone wherever they
// lie): a head is found by comparing with the previous pixel (a shuffle
// across lanes), a run's length from the next head (__ffs on a ballot), its
// minimum distance by a segmented min-scan of shuffles, and only heads
// issue atomics, so a uniform zone costs one atomic a warp's 128 pixels,
// not one a pixel.  ok and zlev are written in the same pass; after one
// barrier each block writes its labels' zsize and zdist once, with vector
// stores: no zeroing pass and no re-read of the outputs.  Bound on the
// card: bytes (13-17 read, 13 written a pixel) and, at the main buckets,
// the launch and one round of load latency.
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NYX_FAR (1 << 30)  // the plain version's fill of a distance minimum
#define NYX_ZS_THREADS 1024
#define NYX_ZS_CLUSTER_MAX 16

// the 4 pixels [q, q + 4) of a ROI a lane holds
struct ZsPix {
  int4 anc, lev, dist;
  unsigned int valid;  // byte k: pixel q + k
};

__device__ __forceinline__ int zs_at(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// pixels q .. q + 3 of one ROI's arrays; those at or past ``end`` read as
// invalid
template <bool VEC, bool DIST>
__device__ __forceinline__ void zs_load(ZsPix& x, const int* __restrict__ anc,
                                        const int* __restrict__ lev,
                                        const unsigned char* __restrict__ valid,
                                        const int* __restrict__ dist, int q,
                                        int end) {
  if (VEC) {  // q, end and the ROI's base are multiples of 4 pixels
    if (q < end) {
      x.anc = __ldg(reinterpret_cast<const int4*>(anc + q));
      x.lev = __ldg(reinterpret_cast<const int4*>(lev + q));
      if (DIST) x.dist = __ldg(reinterpret_cast<const int4*>(dist + q));
      x.valid = __ldg(reinterpret_cast<const unsigned int*>(valid + q));
    } else {
      x.anc = x.lev = x.dist = make_int4(0, 0, 0, 0);
      x.valid = 0u;
    }
    return;
  }
  int a[4] = {0, 0, 0, 0}, l[4] = {0, 0, 0, 0}, d[4] = {0, 0, 0, 0};
  unsigned int v = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (q + k < end) {
      a[k] = __ldg(anc + q + k);
      l[k] = __ldg(lev + q + k);
      if (DIST) d[k] = __ldg(dist + q + k);
      v |= (__ldg(valid + q + k) ? 1u : 0u) << (8 * k);
    }
  }
  x.anc = make_int4(a[0], a[1], a[2], a[3]);
  x.lev = make_int4(l[0], l[1], l[2], l[3]);
  x.dist = make_int4(d[0], d[1], d[2], d[3]);
  x.valid = v;
}

// one ROI's (or one cluster block's) counters in shared memory: S labels'
// sizes (S words), then with DIST their distance minima (S ints), then a
// seed byte a label (S is a multiple of 4)
__host__ __device__ __forceinline__ int zs_smem_bytes(int S, bool dist) {
  return 4 * S + (dist ? 4 * S : 0) + ((S + 15) & ~15);
}

template <bool DIST, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(NYX_ZS_THREADS)
    zone_stats_kernel(const int* __restrict__ anc, const int* __restrict__ lev,
                      const unsigned char* __restrict__ valid,
                      const int* __restrict__ dist, int* __restrict__ zlev,
                      int* __restrict__ zsize, int* __restrict__ zdist,
                      unsigned char* __restrict__ ok, int A, int S) {
  extern __shared__ __align__(16) unsigned char zs_smem[];
  // this block's ROI, and its rank in its cluster (0 on the smem path)
  int b = blockIdx.x, rank = 0;
  if (CLUSTER) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    b = blockIdx.x / static_cast<int>(cg::this_cluster().num_blocks());
  }
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  unsigned int* cnt = reinterpret_cast<unsigned int*>(zs_smem);
  int* dmin = reinterpret_cast<int*>(zs_smem + 4 * S);
  unsigned int* seed =
      reinterpret_cast<unsigned int*>(zs_smem + 4 * S + (DIST ? 4 * S : 0));
  // the pixels (and labels) of this block: [lo, hi)
  const int lo = rank * S;
  const int hi = min(A, lo + S);
  const size_t base = static_cast<size_t>(b) * A;
  const int* ab = anc + base;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  const int* db = DIST ? dist + base : nullptr;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int nw = T >> 5;
  const int nch = hi > lo ? (hi - lo + 127) >> 7 : 0;

  // the first chunk's loads fly while the counters are reset
  int c = warp;
  ZsPix cur;
  if (c < nch) zs_load<VEC, DIST>(cur, ab, lb, vb, db,
                                  lo + (c << 7) + 4 * lane, hi);
  for (int t = tid; t < S / 4; t += T) {
    reinterpret_cast<uint4*>(cnt)[t] = make_uint4(0u, 0u, 0u, 0u);
    if (DIST)
      reinterpret_cast<int4*>(dmin)[t] =
          make_int4(NYX_FAR, NYX_FAR, NYX_FAR, NYX_FAR);
  }
  if (CLUSTER)
    cg::this_cluster().sync();  // every block's counters reset
  else
    __syncthreads();

  // a run of ``len`` pixels of label ``key`` with minimum distance ``mn``
  auto emit = [&](int key, int len, int mn) {
    int owner = 0, off = key;
    if (CLUSTER) {
      owner = key / S;
      off = key - owner * S;
    }
    const unsigned int add = static_cast<unsigned int>(len);
    if (!CLUSTER || owner == rank) {
      atomicAdd(cnt + off, add);
      if (DIST) atomicMin(dmin + off, mn);
    } else {
      nyx_red_add(nyx_mapa(cnt + off, owner), add);
      if (DIST) nyx_red_min(nyx_mapa(dmin + off, owner), mn);
    }
  };

  while (c < nch) {  // c is the same for the whole warp
    const int c2 = c + nw;
    ZsPix nxt;
    if (c2 < nch) zs_load<VEC, DIST>(nxt, ab, lb, vb, db,
                                     lo + (c2 << 7) + 4 * lane, hi);
    const int q = lo + (c << 7) + 4 * lane;
    int key[4], d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = zs_at(cur.anc, k);
      key[k] = ((cur.valid >> (8 * k)) & 0xffu) &&
                       static_cast<unsigned int>(a) <
                           static_cast<unsigned int>(A)
                   ? a
                   : -1;
      d[k] = DIST ? zs_at(cur.dist, k) : 0;
    }
    // run heads: a pixel whose label differs from the previous pixel's
    // (lane 0's first pixel always)
    const int left = __shfl_up_sync(NYX_FULL, key[3], 1);
    unsigned int m = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int before = k ? key[k - 1] : (lane ? left : -2);
      if (key[k] != before) m |= 1u << k;
    }
    // the first head after this lane: of the next lane that has one
    const unsigned int heads = __ballot_sync(NYX_FULL, m != 0u);
    const int first = m ? __ffs(m) - 1 : 4;
    const unsigned int later = heads & ~((2u << lane) - 1u);
    const int nl = later ? __ffs(later) - 1 : 0;
    const int nfirst = __shfl_sync(NYX_FULL, first, nl);
    const int next = later ? 4 * nl + nfirst : 128;
    // the minimum distance from the start of lane j + 1 up to the next
    // head: a segmented suffix min over the lanes of the minimum before
    // each lane's first head
    int after = INT_MAX;
    if (DIST) {
      int v = INT_MAX;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < first) v = min(v, d[k]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        // v covers lanes [lane, lane + o) up to their first head, if any
        const int nv = __shfl_down_sync(NYX_FULL, v, o);
        if (!((heads >> lane) & ((1u << o) - 1u)) && lane + o < 32)
          v = min(v, nv);
      }
      after = __shfl_down_sync(NYX_FULL, v, 1);
      if (lane == 31) after = INT_MAX;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!((m >> k) & 1u) || key[k] < 0) continue;
      const unsigned int above = m >> (k + 1);
      const int end = above ? k + __ffs(above) : 4;  // in-lane run end
      int mn = INT_MAX;
      if (DIST) {
#pragma unroll
        for (int j = k; j < 4; ++j)
          if (j < end) mn = min(mn, d[j]);
        if (!above) mn = min(mn, after);
      }
      emit(key[k], above ? end - k : next - 4 * lane - k, mn);
    }
    // seeds: ok and zlev now, the seed bytes for the write-out
    if (q < hi) {
      unsigned int okb = 0u;
      int zl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool s = key[k] == q + k;
        okb |= (s ? 1u : 0u) << (8 * k);
        zl[k] = s ? zs_at(cur.lev, k) : 0;
      }
      seed[(q - lo) >> 2] = okb;
      if (VEC) {
        *reinterpret_cast<unsigned int*>(ok + base + q) = okb;
        *reinterpret_cast<int4*>(zlev + base + q) =
            make_int4(zl[0], zl[1], zl[2], zl[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (q + k < hi) {
            ok[base + q + k] = static_cast<unsigned char>((okb >> (8 * k)) & 1u);
            zlev[base + q + k] = zl[k];
          }
        }
      }
    }
    cur = nxt;
    c = c2;
  }
  if (CLUSTER)
    cg::this_cluster().sync();  // every run counted; no remote access after
  else
    __syncthreads();

  // this block's labels, once: zsize and zdist at the seeds, zeros elsewhere
  for (int t = tid; 4 * t < hi - lo; t += T) {
    const int q = lo + 4 * t;
    const unsigned int okb = seed[t];
    int sz[4], dm[4] = {0, 0, 0, 0};
    {
      const uint4 w = reinterpret_cast<const uint4*>(cnt)[t];
      sz[0] = w.x;
      sz[1] = w.y;
      sz[2] = w.z;
      sz[3] = w.w;
    }
    if (DIST) {
      const int4 w = reinterpret_cast<const int4*>(dmin)[t];
      dm[0] = w.x;
      dm[1] = w.y;
      dm[2] = w.z;
      dm[3] = w.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool s = (okb >> (8 * k)) & 1u;
      sz[k] = s ? sz[k] : 0;
      dm[k] = s ? dm[k] : 0;
    }
    if (VEC) {
      *reinterpret_cast<int4*>(zsize + base + q) =
          make_int4(sz[0], sz[1], sz[2], sz[3]);
      if (DIST)
        *reinterpret_cast<int4*>(zdist + base + q) =
            make_int4(dm[0], dm[1], dm[2], dm[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (q + k < hi) {
          zsize[base + q + k] = sz[k];
          if (DIST) zdist[base + q + k] = dm[k];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// "device": a block a ROI, the counters in the output buffers

__global__ void zone_stats_device_kernel(const int* __restrict__ anc,
                                         const int* __restrict__ lev,
                                         const unsigned char* __restrict__ valid,
                                         const int* __restrict__ dist,
                                         int* __restrict__ zlev,
                                         int* __restrict__ zsize,
                                         int* __restrict__ zdist,
                                         unsigned char* __restrict__ ok, int A) {
  const size_t base = static_cast<size_t>(blockIdx.x) * A;
  const int* ab = anc + base;
  const unsigned char* vb = valid + base;
  int* sb = zsize + base;
  int* db = dist ? zdist + base : nullptr;
  for (int p = threadIdx.x; p < A; p += blockDim.x) {
    sb[p] = 0;
    if (db) db[p] = NYX_FAR;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < A; p += blockDim.x) {
    if (!vb[p]) continue;
    const int r = ab[p];
    if (r < 0 || r >= A) continue;
    atomicAdd(sb + r, 1);
    if (db) atomicMin(db + r, dist[base + p]);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < A; p += blockDim.x) {
    const bool seed = vb[p] && ab[p] == p;
    ok[base + p] = seed;
    zlev[base + p] = seed ? lev[base + p] : 0;
    if (!seed) {
      sb[p] = 0;
      if (db) db[p] = 0;
    }
  }
}

template <bool DIST, bool VEC, bool CLUSTER>
static int zs_launch(const void* anc, const void* lev, const void* valid,
                     const void* dist, void* zlev, void* zsize, void* zdist,
                     void* ok, int B, int A, int C, int T, int smem,
                     cudaStream_t st) {
  auto kern = zone_stats_kernel<DIST, VEC, CLUSTER>;
  static NyxClusterAttrs done;
  const int S = ((A + C - 1) / C + 3) & ~3;
  if (smem != zs_smem_bytes(S, DIST) || T > NYX_ZS_THREADS || T % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  cfg.numAttrs = CLUSTER ? 1 : 0;
  e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const int*>(anc), static_cast<const int*>(lev),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(dist),
      static_cast<int*>(zlev), static_cast<int*>(zsize),
      static_cast<int*>(zdist), static_cast<unsigned char*>(ok), A, S);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool DIST>
static int zs_dispatch(int vec, int cluster, const void* anc, const void* lev,
                       const void* valid, const void* dist, void* zlev,
                       void* zsize, void* zdist, void* ok, int B, int A, int C,
                       int T, int smem, cudaStream_t st) {
#define NYX_ZS_ARGS anc, lev, valid, dist, zlev, zsize, zdist, ok, B, A, C, T, smem, st
  if (vec)
    return cluster ? zs_launch<DIST, true, true>(NYX_ZS_ARGS)
                   : zs_launch<DIST, true, false>(NYX_ZS_ARGS);
  return cluster ? zs_launch<DIST, false, true>(NYX_ZS_ARGS)
                 : zs_launch<DIST, false, false>(NYX_ZS_ARGS);
#undef NYX_ZS_ARGS
}

// dist and zdist are both NULL, or both given.  path: 0 "smem", 1
// "cluster", 2 "device"; C blocks a ROI (cluster), T threads a block, smem
// bytes and vec (16-byte vectors: A % 4 == 0 and every array 16-byte
// aligned) as ops/zones.py zone_stats_plan and zone_list give them.
extern "C" int nyx_zone_stats(const void* anc, const void* lev,
                              const void* valid, const void* dist, void* zlev,
                              void* zsize, void* zdist, void* ok, int B, int A,
                              int path, int C, int T, int smem, int vec,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 2) {
    zone_stats_device_kernel<<<B, NYX_BLOCK, 0, st>>>(
        static_cast<const int*>(anc), static_cast<const int*>(lev),
        static_cast<const unsigned char*>(valid), static_cast<const int*>(dist),
        static_cast<int*>(zlev), static_cast<int*>(zsize),
        static_cast<int*>(zdist), static_cast<unsigned char*>(ok), A);
    return static_cast<int>(cudaGetLastError());
  }
  if ((path != 0 && path != 1) || C < 1 || C > NYX_ZS_CLUSTER_MAX ||
      (path == 0 && C != 1) || (vec && A % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cl = path == 1;
  return dist ? zs_dispatch<true>(vec, cl, anc, lev, valid, dist, zlev, zsize,
                                  zdist, ok, B, A, C, T, smem, st)
              : zs_dispatch<false>(vec, cl, anc, lev, valid, dist, zlev,
                                   zsize, zdist, ok, B, A, C, T, smem, st);
}
