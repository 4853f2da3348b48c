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
// - "grid": C blocks a ROI of 4 T pixels each (T threads), every SM busy
//   at a whole-slide or whole-volume crop, the counters in the output
//   buffers: a memset, a counting launch, a finishing launch.  The runs
//   that cross a block's warps are joined through shared memory, and the
//   runs of a zone from before the block that repeat in a warp are summed
//   in shared memory, so that such a zone costs one global add (and one
//   max) a block: a uniform zone of 33 M voxels sends ~8 k atomics to its
//   one address, not one a warp or a pixel, and so do two zones whose
//   short runs interleave.  The distance
//   minimum is kept as d ^ 0x7fffffff under an unsigned max, whose
//   identity is 0 (d = INT_MAX), so a memset of 0 starts both counters and
//   the finishing launch decodes it at the seeds and clears the labels
//   that are no seeds.
// A lane holds 4 consecutive pixels, read as 16-byte vectors of anc, lev
// and dist and 4 bytes of valid where A is a multiple of 4 and the rows
// are aligned, so that a warp walks 128 consecutive pixels.  Consecutive
// pixels with the same label form a run (a run may cross rows: pixels of
// one label are one zone wherever they lie): a head is found by comparing
// with the previous pixel (a shuffle across lanes), a run's length from the
// next head (__ffs on a ballot), its minimum distance by a segmented
// min-scan of shuffles, and only heads issue atomics, so a uniform zone
// costs one atomic a warp's 128 pixels (a grid block's 4 T), not one a
// pixel.  ok and zlev are written in the same pass.  On the first two
// paths, after one barrier each block writes its labels' zsize and zdist
// once, with vector stores: no zeroing pass and no re-read of the outputs.
// Bound on the card: bytes (13-17 read, 13 written a pixel) and, at the
// main buckets, the launch and one round of load latency; the grid path
// moves ~27-43 bytes a pixel (the memset, the counting pass, the
// finishing pass's re-read) plus its atomics.
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NYX_FAR (1 << 30)  // the plain version's fill of a distance minimum
#define NYX_ZS_THREADS 1024
#define NYX_ZS_CLUSTER_MAX 16
#define NYX_ZS_FINISH_BLOCKS 4096
#define NYX_ZS_TABLE_BITS 10  // a grid block's table of other labels
#define NYX_ZS_TABLE (1 << NYX_ZS_TABLE_BITS)
#define NYX_ZS_PROBES 2

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

// One warp's 128 pixels (lane j: pixels 4 j .. 4 j + 3) as runs.
struct ZsRuns {
  int key[4];          // the label, -1 where invalid or outside [0, A)
  int d[4];            // the distances (DIST)
  unsigned int m;      // this lane's heads, bit k: pixel k
  int next;            // the warp's first head after this lane (128: none)
  int after;           // the least distance from the next lane up to next
  int pre, pre_min;    // (GRID, lane 0) pixels before the warp's first
                       // head (128: none) and their least distance
};

template <bool DIST>
__device__ __forceinline__ void zs_keys(ZsRuns& r, const ZsPix& x, int A) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int a = zs_at(x.anc, k);
    r.key[k] = ((x.valid >> (8 * k)) & 0xffu) &&
                       static_cast<unsigned int>(a) <
                           static_cast<unsigned int>(A)
                   ? a
                   : -1;
    r.d[k] = DIST ? zs_at(x.dist, k) : 0;
  }
}

// heads, run ends and the segmented min-scan of r's keys; ``left`` is the
// key before the warp's first pixel (-2: none, that pixel a head)
template <bool DIST, bool GRID>
__device__ __forceinline__ void zs_runs(ZsRuns& r, int lane, int left) {
  // run heads: a pixel whose label differs from the previous pixel's
  const int up = __shfl_up_sync(NYX_FULL, r.key[3], 1);
  r.m = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int before = k ? r.key[k - 1] : (lane ? up : left);
    if (r.key[k] != before) r.m |= 1u << k;
  }
  // the first head after this lane: of the next lane that has one
  const unsigned int heads = __ballot_sync(NYX_FULL, r.m != 0u);
  const int first = r.m ? __ffs(r.m) - 1 : 4;
  const unsigned int later = heads & ~((2u << lane) - 1u);
  const int nl = later ? __ffs(later) - 1 : 0;
  const int nfirst = __shfl_sync(NYX_FULL, first, nl);
  r.next = later ? 4 * nl + nfirst : 128;
  if (GRID) {
    const int fl = heads ? __ffs(heads) - 1 : 0;
    const int ffirst = __shfl_sync(NYX_FULL, first, fl);
    r.pre = heads ? 4 * fl + ffirst : 128;
  }
  // the minimum distance from the start of lane j + 1 up to the next
  // head: a segmented suffix min over the lanes of the minimum before
  // each lane's first head
  r.after = INT_MAX;
  r.pre_min = INT_MAX;
  if (DIST) {
    int v = INT_MAX;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < first) v = min(v, r.d[k]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      // v covers lanes [lane, lane + o) up to their first head, if any
      const int nv = __shfl_down_sync(NYX_FULL, v, o);
      if (!((heads >> lane) & ((1u << o) - 1u)) && lane + o < 32)
        v = min(v, nv);
    }
    r.after = __shfl_down_sync(NYX_FULL, v, 1);
    if (lane == 31) r.after = INT_MAX;
    r.pre_min = v;
  }
}

// emit(has, key, len, mn) for k = 0 .. 3 in every lane (the warp stays
// converged): ``has`` where this lane's pixel k heads a run of a label in
// [0, A); the run that reaches the warp's end goes on for ``tail`` more
// pixels of least distance ``tail_min``
template <bool DIST, class Emit>
__device__ __forceinline__ void zs_emit(const ZsRuns& r, int lane, int tail,
                                        int tail_min, Emit emit) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool has = ((r.m >> k) & 1u) && r.key[k] >= 0;
    const unsigned int above = r.m >> (k + 1);
    const int end = above ? k + __ffs(above) : 4;  // in-lane run end
    int mn = INT_MAX;
    if (DIST) {
#pragma unroll
      for (int j = k; j < 4; ++j)
        if (j < end) mn = min(mn, r.d[j]);
      if (!above) mn = min(mn, r.after);
    }
    int len = above ? end - k : r.next - 4 * lane - k;
    if (!above && r.next == 128) {
      len += tail;
      if (DIST) mn = min(mn, tail_min);
    }
    emit(has, r.key[k], len, mn);
  }
}

// ok and zlev of the pixels q .. q + 3 (of [0, end)) of the arrays at
// ``ok`` and ``zlev``, whose first pixel has the raster index ``p``;
// returns the seed bytes
template <bool VEC>
__device__ __forceinline__ unsigned int zs_seeds(const ZsRuns& r,
                                                 const ZsPix& x,
                                                 unsigned char* ok, int* zlev,
                                                 int q, int end, int p) {
  unsigned int okb = 0u;
  int zl[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool s = r.key[k] == p + k;
    okb |= (s ? 1u : 0u) << (8 * k);
    zl[k] = s ? zs_at(x.lev, k) : 0;
  }
  if (VEC) {
    *reinterpret_cast<unsigned int*>(ok + q) = okb;
    *reinterpret_cast<int4*>(zlev + q) = make_int4(zl[0], zl[1], zl[2], zl[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (q + k < end) {
        ok[q + k] = static_cast<unsigned char>((okb >> (8 * k)) & 1u);
        zlev[q + k] = zl[k];
      }
    }
  }
  return okb;
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
  auto emit = [&](bool has, int key, int len, int mn) {
    if (!has) return;
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
    ZsRuns r;
    zs_keys<DIST>(r, cur, A);
    zs_runs<DIST, false>(r, lane, -2);
    zs_emit<DIST>(r, lane, 0, INT_MAX, emit);
    // seeds: ok and zlev now, the seed bytes for the write-out
    if (q < hi)
      seed[(q - lo) >> 2] =
          zs_seeds<VEC>(r, cur, ok + base, zlev + base, q, hi, q);
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
// "grid": C blocks a ROI, the counters (zeroed by a memset) in the output
// buffers

// a distance minimum kept under an unsigned max: decreasing in d, 0 at
// INT_MAX; its own inverse
__device__ __forceinline__ unsigned int zs_far(int d) {
  return static_cast<unsigned int>(d) ^ 0x7fffffffu;
}

// a seed's minimum from its kept word, at most the plain version's fill
__device__ __forceinline__ int zs_dmin(int w) {
  return min(static_cast<int>(zs_far(w)), NYX_FAR);
}

// block j of ROI b counts the pixels [4 T j, 4 T j + 4 T) of the ROI, a
// warp its 128 pixels, and writes their ok and zlev.  A run whose label is
// one of the block's own pixels adds straight to the output.  A run of a
// label from before the block (a zone that began blocks back) joins the
// runs of the same label in its warp's round of heads (__match_any_sync);
// a group of two or more adds in a shared table of NYX_ZS_TABLE slots
// (NYX_ZS_PROBES probes), a lone run adds there only where its label
// already holds a slot, and what finds no slot adds straight to the
// output; after a barrier each used slot adds once to the output.  So a
// zone that crosses many blocks costs one atomic a block even where its
// short runs interleave with another's (two levels in noise), while the
// many small zones of a noisy 3D crop pay an atomic a run and a lookup.
template <bool DIST, bool VEC>
__global__ void __launch_bounds__(NYX_ZS_THREADS)
    zone_stats_grid_kernel(const int* __restrict__ anc,
                           const int* __restrict__ lev,
                           const unsigned char* __restrict__ valid,
                           const int* __restrict__ dist, int* __restrict__ zlev,
                           int* __restrict__ zsize, int* __restrict__ zdist,
                           unsigned char* __restrict__ ok, int A, int C) {
  // labels from before the block: keys (-1 free), sizes, kept minima
  __shared__ int tkey[NYX_ZS_TABLE], tcnt[NYX_ZS_TABLE];
  __shared__ unsigned int tdm[DIST ? NYX_ZS_TABLE : 1];
  // a warp's last key, its pixels before its first head and their least
  // distance
  __shared__ int last[32], pre[32], pre_min[32];
  const int b = blockIdx.x / C;
  const int j = blockIdx.x - b * C;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int P = 4 * T;
  const int lo = j * P;            // < A
  const int n = min(A - lo, P);    // the block's pixels
  const size_t base = static_cast<size_t>(b) * A;
  const size_t at = base + lo;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = T >> 5;
  const int q = (warp << 7) + 4 * lane;  // in the block

  ZsPix x;
  zs_load<VEC, DIST>(x, anc + at, lev + at, valid + at,
                     DIST ? dist + at : nullptr, q, n);
  for (int t = tid; t < NYX_ZS_TABLE; t += T) {  // while the loads fly
    tkey[t] = -1;
    tcnt[t] = 0;
    if (DIST) tdm[t] = 0u;
  }
  ZsRuns r;
  zs_keys<DIST>(r, x, A);
  if (lane == 31) last[warp] = r.key[3];
  if (q < n) zs_seeds<VEC>(r, x, ok + at, zlev + at, q, n, lo + q);
  __syncthreads();
  zs_runs<DIST, true>(r, lane, warp ? last[warp - 1] : -2);
  if (lane == 0) {
    pre[warp] = r.pre;
    pre_min[warp] = r.pre_min;
  }
  __syncthreads();
  // the run at this warp's end goes on through the next warps' first
  // pixels, up to the first warp with a head (past the block's last warp:
  // a head, the next block counts its own part)
  const int wj = warp + 1 + lane;
  const int pl = wj < nw ? pre[wj] : 0;
  const unsigned int stop = __ballot_sync(NYX_FULL, pl < 128);
  const bool on = lane <= __ffs(stop) - 1;  // lane 31 always stops
  const int tail = __reduce_add_sync(NYX_FULL, on ? pl : 0);
  int tail_min = INT_MAX;
  if (DIST)
    tail_min = __reduce_min_sync(NYX_FULL,
                                 on && wj < nw ? pre_min[wj] : INT_MAX);
  int* sb = zsize + base;
  unsigned int* db = reinterpret_cast<unsigned int*>(zdist) + base;
  auto out = [&](int key, int len, unsigned int dm) {
    atomicAdd(sb + key, len);
    if (DIST) atomicMax(db + key, dm);
  };
  zs_emit<DIST>(r, lane, tail, tail_min, [&](bool has, int key, int len,
                                             int mn) {
    const bool far = has && key < lo;
    if (has && !far) out(key, len, zs_far(mn));
    if (!__any_sync(NYX_FULL, far)) return;
    const unsigned int g = __match_any_sync(NYX_FULL, far ? key : -1);
    if (!far) return;
    const int sum = __reduce_add_sync(g, len);
    const unsigned int dm = zs_far(DIST ? __reduce_min_sync(g, mn) : 0);
    if (lane != __ffs(g) - 1) return;
    unsigned int h = (static_cast<unsigned int>(key) * 2654435761u) >>
                     (32 - NYX_ZS_TABLE_BITS);
    for (int p = 0; p < NYX_ZS_PROBES; ++p) {
      const int prev =
          __popc(g) > 1 ? atomicCAS(tkey + h, -1, key) : tkey[h];
      if (prev == key || (prev == -1 && __popc(g) > 1)) {
        atomicAdd(tcnt + h, sum);
        if (DIST) atomicMax(tdm + h, dm);
        return;
      }
      h = (h + 1) & (NYX_ZS_TABLE - 1);
    }
    out(key, sum, dm);
  });
  __syncthreads();
  for (int t = tid; t < NYX_ZS_TABLE; t += T) {  // each used slot once
    const int key = tkey[t];
    if (key >= 0) out(key, tcnt[t], DIST ? tdm[t] : 0u);
  }
}

// every pixel of the B ROIs: zsize and zdist kept (zdist decoded) at the
// seeds, zeros elsewhere; a store only where the word changes
template <bool DIST, bool VEC>
__global__ void zone_stats_finish_kernel(int* __restrict__ zsize,
                                         int* __restrict__ zdist,
                                         const unsigned char* __restrict__ ok,
                                         size_t N) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t t = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (VEC) {
    for (; t < N / 4; t += stride) {
      const unsigned int o =
          __ldg(reinterpret_cast<const unsigned int*>(ok) + t);
      int4* sp = reinterpret_cast<int4*>(zsize) + t;
      const int4 s = *sp;
      const int4 ns = make_int4(o & 0xffu ? s.x : 0, o & 0xff00u ? s.y : 0,
                                o & 0xff0000u ? s.z : 0,
                                o & 0xff000000u ? s.w : 0);
      if (ns.x != s.x || ns.y != s.y || ns.z != s.z || ns.w != s.w) *sp = ns;
      if (DIST) {
        int4* dp = reinterpret_cast<int4*>(zdist) + t;
        const int4 d = *dp;
        const int4 nd = make_int4(o & 0xffu ? zs_dmin(d.x) : 0,
                                  o & 0xff00u ? zs_dmin(d.y) : 0,
                                  o & 0xff0000u ? zs_dmin(d.z) : 0,
                                  o & 0xff000000u ? zs_dmin(d.w) : 0);
        if (nd.x != d.x || nd.y != d.y || nd.z != d.z || nd.w != d.w)
          *dp = nd;
      }
    }
    return;
  }
  for (; t < N; t += stride) {
    const bool s = ok[t];
    if (!s && zsize[t]) zsize[t] = 0;
    if (DIST) zdist[t] = s ? zs_dmin(zdist[t]) : 0;
  }
}

template <bool DIST, bool VEC>
static int zs_grid(const void* anc, const void* lev, const void* valid,
                   const void* dist, void* zlev, void* zsize, void* zdist,
                   void* ok, int B, int A, int C, int T, cudaStream_t st) {
  const size_t N = static_cast<size_t>(B) * A;
  cudaError_t e = cudaMemsetAsync(zsize, 0, 4 * N, st);
  if (e == cudaSuccess && DIST) e = cudaMemsetAsync(zdist, 0, 4 * N, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  zone_stats_grid_kernel<DIST, VEC>
      <<<static_cast<unsigned int>(B) * C, T, 0, st>>>(
          static_cast<const int*>(anc), static_cast<const int*>(lev),
          static_cast<const unsigned char*>(valid),
          static_cast<const int*>(dist), static_cast<int*>(zlev),
          static_cast<int*>(zsize), static_cast<int*>(zdist),
          static_cast<unsigned char*>(ok), A, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t work = VEC ? N / 4 : N;
  const size_t blocks = (work + NYX_BLOCK - 1) / NYX_BLOCK;
  zone_stats_finish_kernel<DIST, VEC>
      <<<static_cast<unsigned int>(
             blocks < NYX_ZS_FINISH_BLOCKS ? blocks : NYX_ZS_FINISH_BLOCKS),
         NYX_BLOCK, 0, st>>>(static_cast<int*>(zsize),
                             static_cast<int*>(zdist),
                             static_cast<const unsigned char*>(ok), N);
  return static_cast<int>(cudaGetLastError());
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
static int zs_dispatch(int path, int vec, const void* anc, const void* lev,
                       const void* valid, const void* dist, void* zlev,
                       void* zsize, void* zdist, void* ok, int B, int A, int C,
                       int T, int smem, cudaStream_t st) {
#define NYX_ZS_ARGS anc, lev, valid, dist, zlev, zsize, zdist, ok, B, A, C, T
  if (path == 2)
    return vec ? zs_grid<DIST, true>(NYX_ZS_ARGS, st)
               : zs_grid<DIST, false>(NYX_ZS_ARGS, st);
  if (vec)
    return path ? zs_launch<DIST, true, true>(NYX_ZS_ARGS, smem, st)
                : zs_launch<DIST, true, false>(NYX_ZS_ARGS, smem, st);
  return path ? zs_launch<DIST, false, true>(NYX_ZS_ARGS, smem, st)
              : zs_launch<DIST, false, false>(NYX_ZS_ARGS, smem, st);
#undef NYX_ZS_ARGS
}

// dist and zdist are both NULL, or both given.  path: 0 "smem", 1
// "cluster", 2 "grid"; C blocks a ROI (cluster: its slabs; grid:
// ceil(A / 4 T)), T threads a block, smem bytes (0 on the grid path) and
// vec (16-byte vectors: A % 4 == 0 and every array 16-byte aligned) as
// ops/zones.py zone_stats_plan and zone_list give them.  A < 2^31; the
// [B, A] arrays are indexed with 64-bit offsets.
extern "C" int nyx_zone_stats(const void* anc, const void* lev,
                              const void* valid, const void* dist, void* zlev,
                              void* zsize, void* zdist, void* ok, int B, int A,
                              int path, int C, int T, int smem, int vec,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || A < 1 || path < 0 || path > 2 || C < 1 || T < 32 ||
      T > NYX_ZS_THREADS || T % 32 != 0 || (vec && A % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 2 ? (smem != 0 || C != (A - 1) / (4 * T) + 1)
                : (C > NYX_ZS_CLUSTER_MAX || (path == 0 && C != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return dist ? zs_dispatch<true>(path, vec, anc, lev, valid, dist, zlev,
                                  zsize, zdist, ok, B, A, C, T, smem, st)
              : zs_dispatch<false>(path, vec, anc, lev, valid, dist, zlev,
                                   zsize, zdist, ok, B, A, C, T, smem, st);
}
