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
// Union-find in the label buffer, as K6 (zone_cc4.cu) does in 2D, but over
// the whole grid of voxels rather than one block a ROI: a first launch sets
// parent = own index on valid voxels; a second unites every valid voxel
// with each of its forward neighbours (the half of the neighbourhood with a
// larger raster index: 13 of 26, or 3 of 6) of the same level, always
// linking the larger root under the smaller one (atomicMin on the root,
// retried when another thread linked it first); a third compresses every
// path.  A parent never exceeds its child and stays in the child's
// component, so each component's root is its lowest index: the JAX label.
// Parents are read with __ldcg (at L2, where the atomics are), never from a
// stale L1 line; launches order the three phases.
//
// Distance (6-connectivity launch only; gldzm.cpp:306-352 per z-plane): 1 +
// the steps to the nearest zero level strictly left, right, above or below
// in the voxel's plane, or to the ROI's AABB margin (x = 0 / widths-1, y =
// 0 / heights-1), whichever is nearest; at least 1.  Voxels beyond the AABB
// (level 0 in GLDZM's where(aabb, lev, 0)) count as zero levels, as the JAX
// scans see them.  One block a (ROI, plane): each thread walks rows (both
// directions), then, after a barrier, columns.
//
// Bound on the card: the union-find's dependent L2 round trips (finds and
// atomics), not bytes: each input is read about twice; for the distance,
// the serial row and column walks.
#include "common.cuh"

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
                                 const int* __restrict__ widths,
                                 int* __restrict__ dist, int D, int H, int W) {
  const int b = blockIdx.x / D;  // one block a (ROI, z-plane)
  const size_t base = static_cast<size_t>(blockIdx.x) * H * W;
  const int* lb = lev + base;
  int* db = dist + base;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int NEG = -(1 << 30);
  const int POS = 1 << 30;
  const int w1 = widths[b] - 1;
  const int h1 = heights[b] - 1;
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
// heights and widths the ROIs' [B] AABB sizes.
extern "C" int nyx_cc3d(const void* lev, const void* valid,
                        const void* heights, const void* widths, void* anc,
                        void* dist, int B, int D, int H, int W, int conn26,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int A = D * H * W;
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
      static_cast<const int*>(widths), static_cast<int*>(dist), D, H, W);
  return static_cast<int>(cudaGetLastError());
}
