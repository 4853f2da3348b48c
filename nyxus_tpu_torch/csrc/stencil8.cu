// K4 stencil8: per-pixel 8-neighbour statistics shared by GLDM and NGTDM.
//
// Replaces the shifted2d loops of nyxus_tpu/ops/gldm.py:28-37 and
// nyxus_tpu/ops/ngtdm.py:37-46 (eight padded copies of the crop on the
// TPU).  Over the neighbours of ops/common.py:96 NEIGHBORS8 (pixels outside
// the crop do not participate), for each pixel:
//   same  number of participating neighbours whose level equals the centre's
//         (GLDM dependence, participation = original intensity > 0)
//   nsum  sum of the levels of participating neighbours with level > 0
//   ncnt  number of participating neighbours with level > 0
//         (NGTDM neighbourhood, participation = the family's valid mask)
// GLDM and NGTDM then histogram these with K1 (batched_hist).
//
// Design: one thread per pixel over the flattened [B, H, W] batch, the eight
// neighbour reads served by L1 (neighbouring threads read neighbouring
// addresses).  Bound on the card: memory traffic, 5 bytes read and 12
// written a pixel; integer outputs, so results are exact.
#include "common.cuh"

__global__ void stencil8_kernel(const int* __restrict__ lev,
                                const unsigned char* __restrict__ part,
                                int* __restrict__ same, int* __restrict__ nsum,
                                int* __restrict__ ncnt, long long total, int H,
                                int W) {
  const int DX[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  const int DY[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  const int npx = H * W;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / npx;
    const int p = static_cast<int>(t - b * npx);
    const int y = p / W;
    const int x = p - y * W;
    const int* lb = lev + b * npx;
    const unsigned char* pb = part + b * npx;
    const int l = lb[p];
    int s = 0, ns = 0, nc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int nx = x + DX[k];
      const int ny = y + DY[k];
      if (nx < 0 || nx >= W || ny < 0 || ny >= H) continue;
      const int q = ny * W + nx;
      if (!pb[q]) continue;
      const int m = lb[q];
      s += (m == l);
      if (m > 0) {
        ns += m;
        ++nc;
      }
    }
    same[t] = s;
    nsum[t] = ns;
    ncnt[t] = nc;
  }
}

extern "C" int nyx_stencil8(const void* lev, const void* part, void* same,
                            void* nsum, void* ncnt, int B, int H, int W,
                            void* stream) {
  const long long total = static_cast<long long>(B) * H * W;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  stencil8_kernel<<<static_cast<unsigned int>(blocks), NYX_BLOCK, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(part),
      static_cast<int*>(same), static_cast<int*>(nsum), static_cast<int*>(ncnt),
      total, H, W);
  return static_cast<int>(cudaGetLastError());
}
