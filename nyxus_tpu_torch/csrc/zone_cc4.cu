// K6 zone_cc4: GLDZM zone labels and the per-pixel distance to the border.
//
// Replaces nyxus_tpu/ops/zones.py:85 zone_labels_cc4 (a lax.while_loop of
// N/S pulls and segmented prefix-mins in both directions along x, until
// nothing changes) and nyxus_tpu/ops/gldzm.py:35 border_distance (cummax /
// cummin scans over shifted copies).
//
// Labels: the 4-connected component of valid pixels of equal level,
// labelled by its lowest raster index; BIG = H * W off ``valid``.  Union-find
// in the label buffer: parent = own index on valid pixels, a union across
// every same-level E and S edge that always links the larger root under the
// smaller one (atomicMin on the root, retried when another thread linked it
// first), then path compression.  A parent never exceeds its child and stays
// in the child's component, so each component's root is its lowest index:
// the JAX label.  Parents are read with __ldcg (at L2, where the atomics
// are), never from a stale L1 line.
//
// Distance (gldzm.cpp:306-352): 1 + the steps to the nearest zero level
// strictly left, right, above or below along the row or column, or to the
// ROI's AABB margin (column 0 / widths-1, row 0 / heights-1), whichever is
// nearest; at least 1.  Pixels beyond the AABB (the bucket's padding, level
// 0 in the caller's levels) count as zero levels, exactly as the JAX scans
// see them.  One thread walks each row (both directions), then, after a
// barrier, one thread each column.
//
// Design: one block per ROI; labels and distances live in the output buffers
// in device memory, so any bucket from 8 x 8 to 8192 x 8192 fits.  Bound on
// the card: the union-find's dependent L2 round trips (finds and atomics)
// and the serial line walks, not bytes: each input is read about twice.
#include "common.cuh"

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
    // link root b under a; if b stopped being a root meanwhile, atomicMin
    // may still move it under a, and b's former parent is merged next
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = nyx_find(par, old);
    a = nyx_find(par, a);
  }
}

__global__ void zone_cc4_kernel(const int* __restrict__ lev,
                                const unsigned char* __restrict__ valid,
                                const int* __restrict__ heights,
                                const int* __restrict__ widths,
                                int* __restrict__ anc, int* __restrict__ dist,
                                int H, int W) {
  const int b = blockIdx.x;
  const int npx = H * W;
  const size_t base = static_cast<size_t>(b) * npx;
  const int* lb = lev + base;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  // labels: union-find
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

extern "C" int nyx_zone_cc4(const void* lev, const void* valid,
                            const void* heights, const void* widths, void* anc,
                            void* dist, int B, int H, int W, void* stream) {
  zone_cc4_kernel<<<B, NYX_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(heights), static_cast<const int*>(widths),
      static_cast<int*>(anc), static_cast<int*>(dist), H, W);
  return static_cast<int>(cudaGetLastError());
}
