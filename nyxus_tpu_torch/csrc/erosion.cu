// K8 erosion: EROSIONS_2_VANISH, the number of 3x3-cross erosions of the
// AABB interior before it is empty.
//
// Replaces nyxus_tpu/ops/binary.py:27 erosions_to_vanish, a lax.while_loop
// over the whole batch on the TPU that runs until the slowest ROI is done
// (every step erodes every crop of the bucket).  Here each ROI exits on its
// own.  Semantics are binary.py:46-61 exactly: a step writes
// min(centre, N, S, W, E) at the interior pixels 2 <= x <= w-2,
// 2 <= y <= h-2 and leaves every other pixel frozen at its mask value; the
// step that empties the interior is not counted, and the count stops at
// EROSION_CAP = 1000 (erosion.h:42).  An interior pixel reads only pixels of
// its AABB, so bucket padding never enters.
//
// Design: one block per ROI, the AABB (h x w) as two ping-pong uint8 planes,
// threads striding over the interior; __syncthreads_or() both ends a step
// and tells whether any interior pixel survived.  The planes live in shared
// memory when 2 * H * W fits a block (a 256 x 256 bucket takes 128 KB),
// else in a device scratch buffer of [B, 2, H, W] bytes that the wrapper
// allocates.  Bound on the card: the dependent steps (one barrier each,
// about the ROI's inradius of them), each a pass over the AABB; the bytes
// bound is the mask read once.
#include "common.cuh"

#define NYX_EROSION_CAP 1000

__global__ void erosion_kernel(const unsigned char* __restrict__ mask,
                               const int* __restrict__ heights,
                               const int* __restrict__ widths,
                               unsigned char* scratch, int* __restrict__ out,
                               int H, int W) {
  extern __shared__ unsigned char smem_planes[];
  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  unsigned char* cur = scratch ? scratch + 2 * plane * b : smem_planes;
  unsigned char* nxt = cur + plane;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  const unsigned char* mb = mask + plane * b;
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const unsigned char v = mb[(p / w) * W + p % w] ? 1 : 0;
    cur[p] = v;
    nxt[p] = v;  // the frozen border must read the same in both planes
  }
  __syncthreads();
  const int iw = w - 3;  // interior columns 2 .. w-2
  const int ih = h - 3;
  const int ni = (iw > 0 && ih > 0) ? iw * ih : 0;
  int n = 0;
  while (true) {
    int alive = 0;
    for (int k = threadIdx.x; k < ni; k += blockDim.x) {
      const int y = 2 + k / iw;
      const int x = 2 + k % iw;
      const int p = y * w + x;
      const unsigned char v = cur[p] & cur[p - w] & cur[p + w] & cur[p - 1] &
                              cur[p + 1];
      nxt[p] = v;
      alive |= v;
    }
    // every write of this step is done, and no thread reads ``cur`` again
    // before the next step overwrites it
    if (!__syncthreads_or(alive)) break;
    if (++n >= NYX_EROSION_CAP) break;
    unsigned char* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (threadIdx.x == 0) out[b] = n;
}

// scratch: NULL for the shared-memory planes, else [B, 2, H, W] bytes.
extern "C" int nyx_erosion(const void* mask, const void* heights,
                           const void* widths, void* scratch, void* out, int B,
                           int H, int W, void* stream) {
  const size_t smem = scratch ? 0 : 2 * static_cast<size_t>(H) * W;
  cudaError_t e = nyx_allow_smem(erosion_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  erosion_kernel<<<B, NYX_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(mask), static_cast<const int*>(heights),
      static_cast<const int*>(widths), static_cast<unsigned char*>(scratch),
      static_cast<int*>(out), H, W);
  return static_cast<int>(cudaGetLastError());
}
