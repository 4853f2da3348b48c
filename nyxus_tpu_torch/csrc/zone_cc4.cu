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
// one coalesced write of ``dist``.  Larger crops (1024 x 64, 256 x 256)
// keep parents and distances in the output buffers in device memory (read
// with __ldcg, at L2 where the atomics are) and walk each row, then each
// column, with one thread.
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
// device-memory path

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

__global__ void zone_cc4_global_kernel(const int* __restrict__ lev,
                                       const unsigned char* __restrict__ valid,
                                       const int* __restrict__ heights,
                                       const int* __restrict__ widths,
                                       int* __restrict__ anc,
                                       int* __restrict__ dist, int H, int W) {
  const int b = blockIdx.x;
  const int npx = H * W;
  const size_t base = static_cast<size_t>(b) * npx;
  const int* lb = lev + base;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  // labels: union-find over every same-level E and S edge
  const unsigned char* vb = valid + base;
  int* par = anc + base;
  for (int p = t; p < npx; p += T) par[p] = vb[p] ? p : npx;
  __syncthreads();
  for (int p = t; p < npx; p += T) {
    if (!vb[p]) continue;
    const int l = lb[p];
    const int x = p % W;
    if (x + 1 < W && vb[p + 1] && lb[p + 1] == l) nyx_unite(par, p, p + 1);
    if (p + W < npx && vb[p + W] && lb[p + W] == l) nyx_unite(par, p, p + W);
  }
  __syncthreads();
  for (int p = t; p < npx; p += T)
    if (vb[p]) par[p] = nyx_find(par, p);
  // distances: row walks, then column walks
  const int NEG = -(1 << 30);
  const int POS = 1 << 30;
  const int w1 = widths[b] - 1;
  const int h1 = heights[b] - 1;
  int* db = dist + base;
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

// smem: the shared-memory path's bytes, 8 * H * (W | 1) + H * W (0: the
// device-memory path); threads: the block size (a multiple of 32, <= 1024).
extern "C" int nyx_zone_cc4(const void* lev, const void* valid,
                            const void* heights, const void* widths, void* anc,
                            void* dist, int B, int H, int W, int smem,
                            int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lev);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const int* h = static_cast<const int*>(heights);
  const int* w = static_cast<const int*>(widths);
  int* a = static_cast<int*>(anc);
  int* d = static_cast<int*>(dist);
  if (threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem == 0) {
    zone_cc4_global_kernel<<<B, threads, 0, s>>>(l, v, h, w, a, d, H, W);
    return static_cast<int>(cudaGetLastError());
  }
  const long long need = 8LL * H * (W | 1) + static_cast<long long>(H) * W;
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = nyx_allow_smem(zone_cc4_smem_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  zone_cc4_smem_kernel<<<B, threads, smem, s>>>(l, v, h, w, a, d, H, W);
  return static_cast<int>(cudaGetLastError());
}
