// K13 glcm3d_cooc: 3D grey-level co-occurrence counts over the 13
// directions of the reference's 3D GLCM, with the shift, the cube test and
// the count fused.
//
// Replaces nyxus_tpu/ops/texture3d.py:81 glcm3d_all's matrix build (13
// shifted3d copies of the levels and the AABB mask, then a pair_hist
// scatter per direction on the TPU).  A voxel pair counts when the centre v
// and its neighbour v + offset * (dx, dy, dz) both lie in the ROI's AABB
// cube (depths x heights x widths; the background inside the cube takes
// part, as the reference's MATLAB mode has it).  Axis 2 of the output is the
// NEIGHBOUR level - 1, axis 3 the CENTRE level - 1 (pair_hist(a=nb_lev,
// b=lev_idx)); pairs with a level outside 1..ng are dropped, which is also
// IBSI mode's extra test (levels > 0 at both ends).  ``symmetric`` adds the
// transpose on write-out (the reference symmetrises only at greyInfo 0).
//
// Design: a grid of (ROI, direction, chunk of 8192 voxels) blocks.  Where
// the ng x ng matrix fits a block's shared memory as 32-bit counts (64
// levels: 16 KB) each block counts there and then adds its non-zero cells
// into a zeroed int32 [B, 13, ng, ng] buffer in device memory; a larger
// matrix (4 * ng^2 > 227 KB: 256 levels and up) is counted straight into
// that buffer.  A second launch converts the counts to the compute dtype
// (adding the transpose when symmetric).  Counts are exact.  Bound on the
// card: the level reads (4 bytes a voxel for the centre, the neighbour's
// mostly from L1/L2) and the atomics; the matrices' write-out at 64 levels.
#include "common.cuh"

#define NYX_GLCM3_CHUNK 8192

struct NyxDirs13 {
  int dz[13];
  int dy[13];
  int dx[13];
};

__global__ void glcm3d_count_kernel(const int* __restrict__ lev,
                                    const int* __restrict__ depths,
                                    const int* __restrict__ heights,
                                    const int* __restrict__ widths,
                                    unsigned int* __restrict__ gcnt, int D,
                                    int H, int W, int ng, NyxDirs13 dirs,
                                    int in_smem) {
  extern __shared__ unsigned int smem_cnt[];
  const int b = blockIdx.x;
  const int a = blockIdx.y;
  const int n2 = ng * ng;
  unsigned int* g = gcnt + (static_cast<size_t>(b) * 13 + a) * n2;
  unsigned int* cnt = in_smem ? smem_cnt : g;
  if (in_smem) {
    for (int k = threadIdx.x; k < n2; k += blockDim.x) cnt[k] = 0u;
    __syncthreads();
  }
  const int HW = H * W;
  const int A = D * HW;
  const int d = depths[b], h = heights[b], w = widths[b];
  const int dz = dirs.dz[a], dy = dirs.dy[a], dx = dirs.dx[a];
  const int* lb = lev + static_cast<size_t>(b) * A;
  const int p0 = blockIdx.z * NYX_GLCM3_CHUNK;
  const int p1 = min(A, p0 + NYX_GLCM3_CHUNK);
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    if (z >= d || y >= h || x >= w) continue;
    const int nz = z + dz, ny = y + dy, nx = x + dx;
    if (nz < 0 || nz >= d || ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
    const int i = lb[nz * HW + ny * W + nx] - 1;  // neighbour level
    const int j = lb[p] - 1;                      // centre level
    if (i < 0 || i >= ng || j < 0 || j >= ng) continue;
    atomicAdd(&cnt[i * ng + j], 1u);
  }
  if (in_smem) {
    __syncthreads();
    for (int k = threadIdx.x; k < n2; k += blockDim.x)
      if (cnt[k]) atomicAdd(g + k, cnt[k]);
  }
}

template <typename T>
__global__ void glcm3d_write_kernel(const unsigned int* __restrict__ gcnt,
                                    T* __restrict__ out, long long total,
                                    int ng, int symmetric) {
  const int n2 = ng * ng;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    unsigned int c = gcnt[t];
    if (symmetric) {
      const long long m = t / n2;
      const int k = static_cast<int>(t - m * n2);
      const int i = k / ng;
      const int j = k - i * ng;
      c += gcnt[m * n2 + j * ng + i];
    }
    out[t] = static_cast<T>(c);
  }
}

template <typename T>
static int launch(const void* lev, const int* dims, void* out, void* gcnt,
                  int B, int D, int H, int W, int ng, const NyxDirs13& dirs,
                  int symmetric, int in_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      in_smem ? sizeof(unsigned int) * static_cast<size_t>(ng) * ng : 0;
  cudaError_t e = nyx_allow_smem(glcm3d_count_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int A = D * H * W;
  dim3 grid(B, 13, (A + NYX_GLCM3_CHUNK - 1) / NYX_GLCM3_CHUNK);
  glcm3d_count_kernel<<<grid, NYX_BLOCK, smem, s>>>(
      static_cast<const int*>(lev), dims, dims + B, dims + 2 * B,
      static_cast<unsigned int*>(gcnt), D, H, W, ng, dirs, in_smem);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(B) * 13 * ng * ng;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  glcm3d_write_kernel<T><<<static_cast<unsigned int>(blocks), NYX_BLOCK, 0, s>>>(
      static_cast<const unsigned int*>(gcnt), static_cast<T*>(out), total, ng,
      symmetric);
  return static_cast<int>(cudaGetLastError());
}

// dims: device int32 [3, B] (depths, heights, widths); shifts: host int[39],
// the 13 (dz, dy, dx) steps already scaled by the offset; gcnt: a zeroed
// int32 [B, 13, ng, ng]; out: [B, 13, ng, ng] of the compute dtype.
extern "C" int nyx_glcm3d_cooc(const void* lev, const void* dims,
                               const void* shifts, void* out, void* gcnt,
                               int B, int D, int H, int W, int ng,
                               int symmetric, int in_smem, int is_f64,
                               void* stream) {
  NyxDirs13 dirs;
  const int* sh = static_cast<const int*>(shifts);
  for (int a = 0; a < 13; ++a) {
    dirs.dz[a] = sh[3 * a];
    dirs.dy[a] = sh[3 * a + 1];
    dirs.dx[a] = sh[3 * a + 2];
  }
  const int* d = static_cast<const int*>(dims);
  return is_f64 ? launch<double>(lev, d, out, gcnt, B, D, H, W, ng, dirs,
                                 symmetric, in_smem, stream)
                : launch<float>(lev, d, out, gcnt, B, D, H, W, ng, dirs,
                                symmetric, in_smem, stream);
}
