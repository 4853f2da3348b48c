// K6 zone_cc4: GLDZM zone labels and the per-pixel distance to the border.
//
// Replaces nyxus_tpu/ops/zones.py:85 zone_labels_cc4 (a lax.while_loop of
// N/S pulls and segmented prefix-mins in both directions along x, until
// nothing changes) and nyxus_tpu/ops/gldzm.py:35 border_distance (cummax /
// cummin scans over shifted copies).
//
// Labels: the 4-connected component of valid pixels of equal level,
// labelled by its lowest raster index; BIG = H * W off ``valid``.  Union-find
// over the parents: a union across a same-level edge always links the
// larger root under the smaller one (atomicMin on the root, retried when
// another thread linked it first), then path compression.  A parent never
// exceeds its child and stays in the child's component, so each
// component's root is its lowest index: the JAX label.
//
// Distance (gldzm.cpp:306-352): 1 + the steps to the nearest zero level
// strictly left, right, above or below along the row or column, or to the
// ROI's AABB margin (column 0 / widths-1, row 0 / heights-1), whichever is
// nearest; at least 1.  Pixels beyond the AABB (the bucket's padding, level
// 0 in the caller's levels) count as zero levels, exactly as the JAX scans
// see them.
//
// Bound on the card: latency, not bytes (each input is read once, each
// output written once: 0.25 us at 64 crops of 32 x 32): dependent finds
// and links, and the steps of the distance scans.  Kept in device memory,
// every find and link is a dependent L2 round trip.
//
// Design, where the crop fits a block's shared memory (the wrapper's
// ``zone_cc4_plan``: 8 * H * (W | 1) + H * W bytes, up to 160 x 160, 128 x
// 128 or 256 x 64): one block per ROI, a warp a row or column up to 1024
// threads (latency, not occupancy, sets the time), loads its levels
// (rows of an odd pitch W | 1, so that a warp reading a column hits 32
// banks) and valid bytes into shared memory.  Each pixel's parent starts
// at the first pixel of its same-level run along the row (a warp per row,
// run starts by ballot), so only vertical edges need unions, and a vertical
// edge whose left neighbours are joined too is skipped.  Unions and path
// compression run on the shared parents; one coalesced write of ``anc``.
// The distances reuse the parents' memory: a warp per row takes the
// nearest zero to the left as an inclusive max-scan of "x where the level
// is 0" (__shfl_up_sync over 32-pixel steps, a carry between steps) and to
// the right as the mirrored min-scan, then a warp per column the same;
// one coalesced write of ``dist``.
//
// Design past a block's shared memory (1024 x 64, 256 x 256, the
// whole-slide 2048² bucket), "tiled", in three launches over many blocks:
// 1. Tile: a block a 64 x 64 tile of a ROI's AABB labels it in shared
//    memory as the path above does (nyx_cc4_local) and writes each pixel's
//    tile root as a raster index of the plane; the tile's part beyond the
//    AABB is filled (anc BIG, dist 1, which is what the distance is there:
//    its margin term is negative) with no union-find.
// 2. Merge, and the rows' distances: a warp a row unites the same-level
//    valid neighbours across the tile borders that row holds, in device
//    memory (nyx_unite: the larger root linked under the smaller by
//    atomicMin, retried, so a root stays its component's lowest index; an
//    edge whose parallel neighbour edge joins the same level is skipped),
//    and runs nyx_line_scans over its AABB columns into ``dist``.
// 3. Flatten, and the columns' distances: a warp a column gives each valid
//    pixel its root and runs nyx_line_scans down the column.
// Only each ROI's AABB is scanned (``valid`` must be false beyond it, as
// the GLDZM caller's participation is; the distance needs no pixel beyond
// it, the margin being nearer than any zero there).  Bound: the levels,
// valid bytes and both outputs once (16.3 us at the whole-slide crop);
// the merge's finds and links are dependent L2 round trips.
#include "common.cuh"

// ---------------------------------------------------------------------------
// shared-memory path

__device__ __forceinline__ int nyx_sfind(volatile int* par, int x) {
  int p = par[x];
  while (p != x) {
    x = p;
    p = par[x];
  }
  return x;
}

__device__ void nyx_sunite(int* par, int a, int b) {
  a = nyx_sfind(par, a);
  b = nyx_sfind(par, b);
  while (a != b) {
    if (a > b) {
      const int s = a;
      a = b;
      b = s;
    }
    // link root b under a; if b stopped being a root meanwhile, atomicMin
    // may still move it under a, and b's former parent is merged next
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = nyx_sfind(par, old);
    a = nyx_sfind(par, a);
  }
}

// One line (a row or a column) of n pixels at stride ``step`` through the
// level tile ``lv`` and the distance tile ``d``, a warp: the nearest zero
// strictly before (d = min(d, i - z, i), ``first``: d is not read yet) and
// strictly after (d = min(d, z - i, m1 - i), with ``last`` the final + 1,
// at least 1).
__device__ __forceinline__ void nyx_line_scans(const int* lv, int* d, int n,
                                               int step, int m1, bool first,
                                               bool last, int lane) {
  const int NEG = -(1 << 30);
  const int POS = 1 << 30;
  int carry = NEG;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    int z = nyx_scan_max(in && lv[i * step] == 0 ? i : NEG, lane);
    z = max(z, carry);
    int ex = __shfl_up_sync(NYX_FULL, z, 1);
    if (lane == 0) ex = carry;
    if (in) {
      const int v = min(i - ex, i);
      d[i * step] = first ? v : min(d[i * step], v);
    }
    carry = __shfl_sync(NYX_FULL, z, 31);
  }
  carry = POS;
  for (int i0 = (n - 1) & ~31; i0 >= 0; i0 -= 32) {
    const int i = i0 + lane;
    const bool in = i < n;
    int z = nyx_scan_min_rev(in && lv[i * step] == 0 ? i : POS, lane);
    z = min(z, carry);
    int ex = __shfl_down_sync(NYX_FULL, z, 1);
    if (lane == 31) ex = carry;
    if (in) {
      const int v = min(d[i * step], min(ex - i, m1 - i));
      d[i * step] = last ? max(v + 1, 1) : v;
    }
    carry = __shfl_sync(NYX_FULL, z, 0);
  }
}

// The labels of an H x W crop in shared memory, by the block: ``ls`` its
// levels (rows of pitch P), ``vs`` its valid bytes and ``par`` its parents
// (both dense, H * W).  Afterwards par[p] is the lowest dense index of p's
// 4-connected same-level component of valid pixels, H * W off valid.  Each
// pixel's parent starts at the first pixel of its same-level run along the
// row (a warp a row, run starts by ballot), so only vertical edges need
// unions, and a vertical edge whose left neighbours are joined too is
// skipped.  The caller synchronises before; this ends with a barrier.
__device__ __forceinline__ void nyx_cc4_local(const int* ls, int P,
                                              const unsigned char* vs,
                                              int* par, int H, int W) {
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = T >> 5;
  const int npx = H * W;
  // parents: each valid pixel under the first pixel of its run along the row
  for (int y = warp; y < H; y += nw) {
    const int* lr = ls + y * P;
    const int row = y * W;
    int carry = 0;  // the run open at the step's left edge starts here
    for (int x0 = 0; x0 < W; x0 += 32) {
      const int x = x0 + lane;
      const bool in = x < W;
      const bool v = in && vs[row + x];
      const bool same = v && x > 0 && vs[row + x - 1] && lr[x] == lr[x - 1];
      const unsigned int upto =
          __ballot_sync(NYX_FULL, !same) & (NYX_FULL >> (31 - lane));
      const int s = upto ? x0 + 31 - __clz(upto) : carry;
      if (in) par[row + x] = v ? row + s : npx;
      carry = __shfl_sync(NYX_FULL, s, 31);
    }
  }
  __syncthreads();
  // unions across vertical same-level edges
  for (int p = t; p < npx - W; p += T) {
    if (!vs[p] || !vs[p + W]) continue;
    const int y = p / W;
    const int x = p - y * W;
    const int l = ls[y * P + x];
    if (ls[y * P + P + x] != l) continue;
    // the edge to the left joins the same two runs
    if (x > 0 && vs[p - 1] && vs[p + W - 1] && ls[y * P + x - 1] == l &&
        ls[y * P + P + x - 1] == l)
      continue;
    nyx_sunite(par, p, p + W);
  }
  __syncthreads();
  for (int p = t; p < npx; p += T)
    if (vs[p]) par[p] = nyx_sfind(par, p);
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
    zone_cc4_smem_kernel(const int* __restrict__ lev,
                         const unsigned char* __restrict__ valid,
                         const int* __restrict__ heights,
                         const int* __restrict__ widths,
                         int* __restrict__ anc, int* __restrict__ dist, int H,
                         int W) {
  extern __shared__ __align__(16) int sm[];
  const int P = W | 1;  // row pitch of the level and distance tiles
  const int npx = H * W;
  int* ls = sm;                 // [H][P] levels
  int* par = sm + H * P;        // [npx] parents, then [H][P] distances
  unsigned char* vs = reinterpret_cast<unsigned char*>(sm + 2 * H * P);
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = T >> 5;
  const size_t base = static_cast<size_t>(b) * npx;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  for (int p = t; p < npx; p += T) {
    const int y = p / W;
    ls[y * P + p - y * W] = lb[p];
    vs[p] = vb[p];
  }
  __syncthreads();
  nyx_cc4_local(ls, P, vs, par, H, W);
  int* ab = anc + base;
  for (int p = t; p < npx; p += T) ab[p] = par[p];
  __syncthreads();
  // distances, in the parents' memory: a warp a row, then a warp a column
  int* ds = par;
  const int w1 = widths[b] - 1;
  const int h1 = heights[b] - 1;
  for (int y = warp; y < H; y += nw)
    nyx_line_scans(ls + y * P, ds + y * P, W, 1, w1, true, false, lane);
  __syncthreads();
  for (int x = warp; x < W; x += nw)
    nyx_line_scans(ls + x, ds + x, H, P, h1, false, true, lane);
  __syncthreads();
  int* db = dist + base;
  for (int p = t; p < npx; p += T) {
    const int y = p / W;
    db[p] = ds[y * P + p - y * W];
  }
}

// ---------------------------------------------------------------------------
// tiled path: union-find in device memory across the tiles

__device__ __forceinline__ int nyx_find(int* par, int x) {
  int p = __ldcg(par + x);
  while (p != x) {
    x = p;
    p = __ldcg(par + x);
  }
  return x;
}

__device__ void nyx_unite(int* par, int a, int b) {
  a = nyx_find(par, a);
  b = nyx_find(par, b);
  while (a != b) {
    if (a > b) {
      const int s = a;
      a = b;
      b = s;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = nyx_find(par, old);
    a = nyx_find(par, a);
  }
}

// "tiled": tiles of NYX_CC4_TILE x NYX_CC4_TILE, each labelled in shared
// memory by its block, then merged across the tile borders and flattened in
// device memory; the distances a warp a row and a warp a column
#define NYX_CC4_TILE 64

// the tile path's shared memory: levels at pitch TILE + 1, parents, valid
// bytes
#define NYX_CC4_TILE_SMEM                                            \
  (4 * NYX_CC4_TILE * (NYX_CC4_TILE + 1) + 4 * NYX_CC4_TILE * NYX_CC4_TILE + \
   NYX_CC4_TILE * NYX_CC4_TILE)

// Launch 1: block (tile, b) labels the tile's part of the ROI's AABB with
// nyx_cc4_local and writes each pixel's tile root as a raster index of the
// plane (the tile's raster order is the plane's, so the root stays the
// lowest index of the tile's component); the tile's part beyond the AABB
// is filled, anc BIG and dist 1 (each term of the distance there is below
// 1), with no union-find.
__global__ void __launch_bounds__(512)
    zone_cc4_tile_kernel(const int* __restrict__ lev,
                         const unsigned char* __restrict__ valid,
                         const int* __restrict__ heights,
                         const int* __restrict__ widths,
                         int* __restrict__ anc, int* __restrict__ dist, int H,
                         int W) {
  extern __shared__ __align__(16) int sm[];
  constexpr int TS = NYX_CC4_TILE;
  constexpr int P = TS + 1;
  int* ls = sm;           // [TS][P] levels
  int* par = sm + TS * P;  // [ah * aw] parents
  unsigned char* vs = reinterpret_cast<unsigned char*>(par + TS * TS);
  const int b = blockIdx.y;
  const int ntx = (W + TS - 1) / TS;
  const int y0 = (blockIdx.x / ntx) * TS;
  const int x0 = (blockIdx.x % ntx) * TS;
  const int th = min(TS, H - y0);
  const int tw = min(TS, W - x0);
  const int ah = max(0, min(th, min(heights[b], H) - y0));
  const int aw = max(0, min(tw, min(widths[b], W) - x0));
  const int npx = H * W;
  const size_t base = static_cast<size_t>(b) * npx;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  for (int k = t; k < th * tw; k += T) {
    const int ly = k / tw;
    const int lx = k - ly * tw;
    if (ly < ah && lx < aw) continue;
    const size_t p = base + static_cast<size_t>(y0 + ly) * W + x0 + lx;
    anc[p] = npx;
    dist[p] = 1;
  }
  if (ah == 0 || aw == 0) return;
  const int n = ah * aw;
  for (int q = t; q < n; q += T) {
    const int ly = q / aw;
    const int lx = q - ly * aw;
    const size_t p = base + static_cast<size_t>(y0 + ly) * W + x0 + lx;
    ls[ly * P + lx] = lev[p];
    vs[q] = valid[p];
  }
  __syncthreads();
  nyx_cc4_local(ls, P, vs, par, ah, aw);
  for (int q = t; q < n; q += T) {
    const int ly = q / aw;
    const int lx = q - ly * aw;
    const int r = par[q];
    anc[base + static_cast<size_t>(y0 + ly) * W + x0 + lx] =
        r == n ? npx : (y0 + r / aw) * W + x0 + r % aw;
  }
}

// Launch 2: a warp a row y < h of a ROI.  The row's distances to the
// nearest zero left and right or to the margin (nyx_line_scans over the
// AABB's columns, in device memory), then the unions across the tile
// borders this row holds: the edges (y, x - 1)-(y, x) at x = k TILE, and,
// where y = k TILE, the edges (y - 1, x)-(y, x).  Each links root under
// root in device memory (nyx_unite: atomicMin, retried), so a root stays
// its component's lowest index.  An edge is skipped where the parallel
// edge one row up (vertical borders, y not a tile's first row) or one
// column left (horizontal borders, x not a tile's first column) joins the
// same level: its two ends are joined through that edge and two edges
// inside tiles.
__global__ void zone_cc4_rows_kernel(const int* __restrict__ lev,
                                     const unsigned char* __restrict__ valid,
                                     const int* __restrict__ heights,
                                     const int* __restrict__ widths,
                                     int* __restrict__ anc,
                                     int* __restrict__ dist, int H, int W) {
  constexpr int TS = NYX_CC4_TILE;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  if (y >= h || w <= 0) return;
  const size_t base = static_cast<size_t>(b) * H * W;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  int* par = anc + base;
  const int row = y * W;
  nyx_line_scans(lb + row, dist + base + row, w, 1, widths[b] - 1, true,
                 false, lane);
  for (int x = TS * (1 + lane); x < w; x += 32 * TS) {
    const int p = row + x;
    if (!vb[p] || !vb[p - 1]) continue;
    const int l = lb[p];
    if (lb[p - 1] != l) continue;
    if (y % TS != 0 && vb[p - W] && vb[p - W - 1] && lb[p - W] == l &&
        lb[p - W - 1] == l)
      continue;
    nyx_unite(par, p - 1, p);
  }
  if (y == 0 || y % TS != 0) return;
  for (int x = lane; x < w; x += 32) {
    const int p = row + x;
    if (!vb[p] || !vb[p - W]) continue;
    const int l = lb[p];
    if (lb[p - W] != l) continue;
    if (x % TS != 0 && vb[p - 1] && vb[p - W - 1] && lb[p - 1] == l &&
        lb[p - W - 1] == l)
      continue;
    nyx_unite(par, p - W, p);
  }
}

// Launch 3: a warp a column x < w of a ROI: every valid pixel of the column
// takes its root (the merges are done), then the column's distances to the
// nearest zero above and below or to the margin finish dist (+ 1, at least
// 1).
__global__ void zone_cc4_cols_kernel(const int* __restrict__ lev,
                                     const unsigned char* __restrict__ valid,
                                     const int* __restrict__ heights,
                                     const int* __restrict__ widths,
                                     int* __restrict__ anc,
                                     int* __restrict__ dist, int H, int W) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  if (x >= w || h <= 0) return;
  const size_t base = static_cast<size_t>(b) * H * W;
  const unsigned char* vb = valid + base;
  int* par = anc + base;
  for (int y = lane; y < h; y += 32) {
    const int p = y * W + x;
    if (vb[p]) par[p] = nyx_find(par, p);
  }
  nyx_line_scans(lev + base + x, dist + base + x, h, W, heights[b] - 1,
                 false, true, lane);
}

// path 0 "smem": smem the bytes, 8 * H * (W | 1) + H * W, threads a block
// (a multiple of 32, <= 1024).  path 1 "tiled": smem NYX_CC4_TILE_SMEM, the
// tile launch's threads (its rows and columns launches run 256).
extern "C" int nyx_zone_cc4(const void* lev, const void* valid,
                            const void* heights, const void* widths, void* anc,
                            void* dist, int B, int H, int W, int path,
                            int smem, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lev);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const int* h = static_cast<const int*>(heights);
  const int* w = static_cast<const int*>(widths);
  int* a = static_cast<int*>(anc);
  int* d = static_cast<int*>(dist);
  if (threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1) {
    constexpr int TS = NYX_CC4_TILE;
    const long long tiles =
        static_cast<long long>((H + TS - 1) / TS) * ((W + TS - 1) / TS);
    if (smem != NYX_CC4_TILE_SMEM || threads > 512 || B > 65535 ||
        tiles > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = nyx_allow_smem(zone_cc4_tile_kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    zone_cc4_tile_kernel<<<dim3(static_cast<unsigned int>(tiles), B), threads,
                           smem, s>>>(l, v, h, w, a, d, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    zone_cc4_rows_kernel<<<dim3((H + 7) / 8, B), 256, 0, s>>>(l, v, h, w, a,
                                                              d, H, W);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    zone_cc4_cols_kernel<<<dim3((W + 7) / 8, B), 256, 0, s>>>(l, v, h, w, a,
                                                              d, H, W);
    return static_cast<int>(cudaGetLastError());
  }
  const long long need = 8LL * H * (W | 1) + static_cast<long long>(H) * W;
  if (path != 0 || smem < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = nyx_allow_smem(zone_cc4_smem_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  zone_cc4_smem_kernel<<<B, threads, smem, s>>>(l, v, h, w, a, d, H, W);
  return static_cast<int>(cudaGetLastError());
}
