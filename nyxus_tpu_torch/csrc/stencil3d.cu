// K16 stencil3d: per-voxel neighbour statistics of the 3D dependence and
// neighbourhood families, over a shift table or a Chebyshev window.
//
// Replaces the shifted3d loops of nyxus_tpu/ops/texture3d.py:350
// gldm3d_all (26 shifts), :402 ngldm3d_all (the reference's 24 NGLDM
// shifts) and :369 ngtdm3d_all (the (2r+1)^3 - 1 offsets of the Chebyshev
// window), each a padded copy of the cube per shift on the TPU.  Neighbours
// outside the cube, or not marked in ``part``, do not take part.  Two
// modes:
//   table   same[v] = number of shifts s with part[v + s] and
//           lev[v + s] == lev[v]   (GLDM: N26, part = the AABB; NGLDM:
//           N24, part = the AABB)
//   window  nsum[v] = sum of lev[v + s] and ncnt[v] = number of s over the
//           marked neighbours in the window of radius r (NGTDM: lev =
//           where(aabb, level, 0), part = the AABB, background included)
// The histograms then go through K1.  Integer outputs, so the kernel equals
// its plain version bit for bit.
//
// Design: one thread per voxel over the flattened [B, D, H, W] batch; the
// shift table is a kernel argument (26 x 3 ints at most), the neighbours'
// reads are served by L1/L2 (neighbouring threads read neighbouring
// addresses, and the planes above and below were read a plane's worth of
// threads earlier).  Bound on the card: memory traffic, 5 bytes read and 4
// (table) or 8 (window) written a voxel, until the window's (2r+1)^3 reads
// outweigh it.
#include "common.cuh"

struct NyxShifts {
  int n;
  int dz[26];
  int dy[26];
  int dx[26];
};

__global__ void stencil3d_table_kernel(const int* __restrict__ lev,
                                       const unsigned char* __restrict__ part,
                                       int* __restrict__ same, long long total,
                                       int D, int H, int W, NyxShifts sh) {
  const int HW = H * W;
  const int A = D * HW;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    const int* lb = lev + b * A;
    const unsigned char* pb = part + b * A;
    const int l = lb[p];
    int s = 0;
    for (int k = 0; k < sh.n; ++k) {
      const int nz = z + sh.dz[k], ny = y + sh.dy[k], nx = x + sh.dx[k];
      if (nz < 0 || nz >= D || ny < 0 || ny >= H || nx < 0 || nx >= W)
        continue;
      const int q = nz * HW + ny * W + nx;
      s += (pb[q] && lb[q] == l);
    }
    same[t] = s;
  }
}

__global__ void stencil3d_window_kernel(const int* __restrict__ lev,
                                        const unsigned char* __restrict__ part,
                                        int* __restrict__ nsum,
                                        int* __restrict__ ncnt, long long total,
                                        int D, int H, int W, int rad) {
  const int HW = H * W;
  const int A = D * HW;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    const int* lb = lev + b * A;
    const unsigned char* pb = part + b * A;
    int s = 0, c = 0;
    for (int nz = max(z - rad, 0); nz <= min(z + rad, D - 1); ++nz) {
      for (int ny = max(y - rad, 0); ny <= min(y + rad, H - 1); ++ny) {
        for (int nx = max(x - rad, 0); nx <= min(x + rad, W - 1); ++nx) {
          if (nz == z && ny == y && nx == x) continue;
          const int q = nz * HW + ny * W + nx;
          if (pb[q]) {
            s += lb[q];
            ++c;
          }
        }
      }
    }
    nsum[t] = s;
    ncnt[t] = c;
  }
}

// shifts: host int[3 * n] (dz, dy, dx) for the table mode (n <= 26), NULL
// for the window mode of radius ``rad`` (then nsum and ncnt are written,
// else same).
extern "C" int nyx_stencil3d(const void* lev, const void* part,
                             const void* shifts, int n, int rad, void* same,
                             void* nsum, void* ncnt, int B, int D, int H,
                             int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(B) * D * H * W;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  const unsigned int nb = static_cast<unsigned int>(blocks);
  if (shifts != nullptr) {
    if (n < 0 || n > 26) return static_cast<int>(cudaErrorInvalidValue);
    NyxShifts sh;
    sh.n = n;
    const int* v = static_cast<const int*>(shifts);
    for (int k = 0; k < n; ++k) {
      sh.dz[k] = v[3 * k];
      sh.dy[k] = v[3 * k + 1];
      sh.dx[k] = v[3 * k + 2];
    }
    stencil3d_table_kernel<<<nb, NYX_BLOCK, 0, s>>>(
        static_cast<const int*>(lev), static_cast<const unsigned char*>(part),
        static_cast<int*>(same), total, D, H, W, sh);
  } else {
    stencil3d_window_kernel<<<nb, NYX_BLOCK, 0, s>>>(
        static_cast<const int*>(lev), static_cast<const unsigned char*>(part),
        static_cast<int*>(nsum), static_cast<int*>(ncnt), total, D, H, W, rad);
  }
  return static_cast<int>(cudaGetLastError());
}
