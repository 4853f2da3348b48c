// K9 binary_quads: the Euler number's 2x2 quad counts and the fractal
// dimension's occupied-box counts of a batch of ROI masks.
//
// Replaces nyxus_tpu/ops/binary.py:70 euler_number (pad, a quad code per
// 2x2 window, one comparison and sum per pattern) and :93-102
// _box_count_at_scale as :105 fract_dim_boxcount calls it (a pad, reshape
// and any for every scale s = SB .. 2 and, where s <= 32, for each of four
// grid origins): dozens of small XLA ops a bucket become one launch.
//
//   quads[b] = (C1, C3, Cd) over the (H+1) x (W+1) windows of the 1-padded
//     mask, with q = 8*p[y,x] + 4*p[y,x+1] + 2*p[y+1,x] + p[y+1,x+1]:
//     C1 counts q in {8, 4, 2, 1}, C3 q in {7, 11, 13, 14}, Cd q in {9, 6}
//     (euler_number.h:42-58).
//   boxes[b, i, k] for scale s = SB >> i (i < S = log2 SB, SB the power of
//     two >= max(H, W)) and grid origin k = (ox, oy) = (0, 0), (s/2, 0),
//     (0, s/2), (s/2, s/2): the number of s x s boxes holding a mask pixel,
//     pixel (y, x) lying in box ((y + oy) / s, (x + ox) / s).  Origins
//     other than (0, 0) are counted only where s <= 32; above, all four
//     entries hold the (0, 0) count.
//
// Design: one block per (ROI, scale) plus one block per ROI for the quads
// (grid (B, S + 1)); block-level sums in shared memory and one write per
// count.  A box of s < 16 is one thread's serial OR over its s x s pixels;
// a larger box is one warp's: the lanes stride over its pixels and
// __any_sync() ORs them, so a 1024 px box is 32 pixels a lane.  Bound on
// the card: reads (every scale and origin reads the crop once, 1 byte a
// pixel, from L1/L2 after the first pass).
#include "common.cuh"

__device__ __forceinline__ int nyx_px(const unsigned char* m, int H, int W,
                                      int y, int x) {
  return (y >= 0 && y < H && x >= 0 && x < W && m[y * W + x]) ? 1 : 0;
}

// 1 when box (by, bx) of side s at origin (ox, oy) holds a mask pixel:
// mask rows by*s - oy .. by*s - oy + s - 1, clipped to the crop.
__device__ __forceinline__ int nyx_box_thread(const unsigned char* m, int H,
                                              int W, int s, int by, int bx,
                                              int oy, int ox) {
  const int y0 = max(by * s - oy, 0), y1 = min(by * s - oy + s, H);
  const int x0 = max(bx * s - ox, 0), x1 = min(bx * s - ox + s, W);
  for (int y = y0; y < y1; ++y)
    for (int x = x0; x < x1; ++x)
      if (m[y * W + x]) return 1;
  return 0;
}

__device__ __forceinline__ int nyx_box_warp(const unsigned char* m, int H,
                                            int W, int s, int by, int bx,
                                            int oy, int ox, int lane) {
  const int y0 = max(by * s - oy, 0), y1 = min(by * s - oy + s, H);
  const int x0 = max(bx * s - ox, 0), x1 = min(bx * s - ox + s, W);
  const int bw = x1 - x0;
  const int n = (y1 > y0 && bw > 0) ? (y1 - y0) * bw : 0;
  int hit = 0;
  for (int k = lane; k < n && !hit; k += 32)
    hit = m[(y0 + k / bw) * W + x0 + k % bw] != 0;
  return __any_sync(0xffffffffu, hit);
}

__global__ void binary_quads_kernel(const unsigned char* __restrict__ mask,
                                    int* __restrict__ quads,
                                    int* __restrict__ boxes, int H, int W,
                                    int SB, int S) {
  __shared__ int cnt[4];
  const int b = blockIdx.x;
  const int i = blockIdx.y;
  const unsigned char* m = mask + static_cast<size_t>(b) * H * W;
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  __syncthreads();
  if (i == S) {
    int c1 = 0, c3 = 0, cd = 0;
    const int nw = (H + 1) * (W + 1);
    for (int k = threadIdx.x; k < nw; k += blockDim.x) {
      const int y = k / (W + 1) - 1;  // window rows y, y+1 of the mask
      const int x = k % (W + 1) - 1;
      const int q = 8 * nyx_px(m, H, W, y, x) + 4 * nyx_px(m, H, W, y, x + 1) +
                    2 * nyx_px(m, H, W, y + 1, x) +
                    nyx_px(m, H, W, y + 1, x + 1);
      c1 += (q == 8) | (q == 4) | (q == 2) | (q == 1);
      c3 += (q == 7) | (q == 11) | (q == 13) | (q == 14);
      cd += (q == 9) | (q == 6);
    }
    atomicAdd(&cnt[0], c1);
    atomicAdd(&cnt[1], c3);
    atomicAdd(&cnt[2], cd);
    __syncthreads();
    if (threadIdx.x < 3) quads[b * 3 + threadIdx.x] = cnt[threadIdx.x];
    return;
  }
  const int s = SB >> i;
  const int norig = s <= 32 ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = 0; k < norig; ++k) {
    const int ox = (k & 1) ? s / 2 : 0;
    const int oy = (k & 2) ? s / 2 : 0;
    const int nbx = (W + ox + s - 1) / s;
    const int nb = ((H + oy + s - 1) / s) * nbx;
    int local = 0;
    if (s < 16) {
      for (int j = threadIdx.x; j < nb; j += blockDim.x)
        local += nyx_box_thread(m, H, W, s, j / nbx, j % nbx, oy, ox);
    } else {
      for (int j = warp; j < nb; j += nwarps)
        local += (lane == 0) &
                 nyx_box_warp(m, H, W, s, j / nbx, j % nbx, oy, ox, lane);
    }
    atomicAdd(&cnt[k], local);
  }
  __syncthreads();
  if (threadIdx.x < 4)
    boxes[(static_cast<size_t>(b) * S + i) * 4 + threadIdx.x] =
        cnt[norig == 4 ? threadIdx.x : 0];
}

// quads: int32 [B, 3]; boxes: int32 [B, S, 4] (S may be 0).
extern "C" int nyx_binary_quads(const void* mask, void* quads, void* boxes,
                                int B, int H, int W, int SB, int S,
                                void* stream) {
  dim3 grid(B, S + 1);
  binary_quads_kernel<<<grid, NYX_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<int*>(quads),
      static_cast<int*>(boxes), H, W, SB, S);
  return static_cast<int>(cudaGetLastError());
}
