// K2 glcm_cooc: grey-level co-occurrence counts for every requested angle,
// with the shift, the background test and the count fused.
//
// Replaces nyxus_tpu/ops/glcm.py:61 cooc_matrices (shifted2d copies plus a
// one-hot matmul per angle on the TPU).  A pixel pair counts when the
// centre's and the neighbour's ORIGINAL intensity are both > 0; the
// neighbour of (y, x) is (y + dy, x + dx) and pixels outside the crop count
// as intensity 0, exactly as shifted2d fills them.  Axis 2 of the output is
// the NEIGHBOUR level - 1, axis 3 the CENTRE level - 1; ``symmetric`` adds
// the transpose on write-out.
//
// Design: one block per (ROI, angle); the ng x ng matrix is kept as 32-bit
// integer counts in shared memory (64 x 64 levels = 16 KB) so the counts are
// exact, and is converted to the compute dtype on the one coalesced
// write-out.  A matrix larger than a block's shared memory (4 * ng^2 >
// 227 KB, i.e. 256 levels) counts with the same atomics in a zeroed int32
// buffer in device memory that the wrapper passes (``gcnt``, [B, n_angles,
// ng, ng]); each block owns its (ROI, angle) slice, so one __syncthreads()
// orders its counts before its own write-out.  Bound on the card: the crop
// read (intensity + level, 8-12 bytes a pixel, each read twice through L1)
// and the atomics on the matrix (shared memory, or L2 on the device-memory
// path).
#include "common.cuh"

struct NyxAngles {
  int n;
  int dx[4];
  int dy[4];
};

template <typename T>
__global__ void glcm_cooc_kernel(const T* __restrict__ orig,
                                 const int* __restrict__ lev,
                                 T* __restrict__ out,
                                 unsigned int* __restrict__ gcnt, int H,
                                 int W, int ng, NyxAngles ang, int symmetric) {
  extern __shared__ unsigned int smem_cnt[];
  const int b = blockIdx.x;
  const int a = blockIdx.y;
  const int n2 = ng * ng;
  unsigned int* cnt =
      gcnt ? gcnt + (static_cast<size_t>(b) * ang.n + a) * n2 : smem_cnt;
  if (!gcnt) {
    for (int k = threadIdx.x; k < n2; k += blockDim.x) cnt[k] = 0u;
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(b) * H * W;
  const T* ob = orig + base;
  const int* lb = lev + base;
  const int dx = ang.dx[a];
  const int dy = ang.dy[a];
  const int npx = H * W;
  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    if (!(ob[p] > T(0))) continue;
    const int y = p / W;
    const int x = p - y * W;
    const int ny = y + dy;
    const int nx = x + dx;
    if (ny < 0 || ny >= H || nx < 0 || nx >= W) continue;
    const int q = ny * W + nx;
    if (!(ob[q] > T(0))) continue;
    const int i = lb[q] - 1;  // neighbour level
    const int j = lb[p] - 1;  // centre level
    if (i < 0 || i >= ng || j < 0 || j >= ng) continue;
    atomicAdd(&cnt[i * ng + j], 1u);
  }
  __syncthreads();
  T* o = out + (static_cast<size_t>(b) * ang.n + a) * n2;
  for (int k = threadIdx.x; k < n2; k += blockDim.x) {
    unsigned int c = gcnt ? __ldcg(cnt + k) : cnt[k];
    if (symmetric) {
      const int i = k / ng;
      const int j = k - i * ng;
      c += gcnt ? __ldcg(cnt + j * ng + i) : cnt[j * ng + i];
    }
    o[k] = static_cast<T>(c);
  }
}

template <typename T>
static int launch(const void* orig, const void* lev, void* out, void* gcnt,
                  int B, int H, int W, int ng, const NyxAngles& ang,
                  int symmetric, void* stream) {
  const size_t smem =
      gcnt ? 0 : sizeof(unsigned int) * static_cast<size_t>(ng) * ng;
  cudaError_t e = nyx_allow_smem(glcm_cooc_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, ang.n);
  glcm_cooc_kernel<T><<<grid, NYX_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(orig), static_cast<const int*>(lev),
      static_cast<T*>(out), static_cast<unsigned int*>(gcnt), H, W, ng, ang,
      symmetric);
  return static_cast<int>(cudaGetLastError());
}

// gcnt: NULL to count in shared memory, else a zeroed int32
// [B, n_angles, ng, ng].
extern "C" int nyx_glcm_cooc(const void* orig, const void* lev, void* out,
                             void* gcnt, int B, int H, int W, int ng,
                             int n_angles,
                             int dx0, int dy0, int dx1, int dy1, int dx2,
                             int dy2, int dx3, int dy3, int symmetric,
                             int is_f64, void* stream) {
  NyxAngles ang;
  ang.n = n_angles;
  ang.dx[0] = dx0; ang.dy[0] = dy0;
  ang.dx[1] = dx1; ang.dy[1] = dy1;
  ang.dx[2] = dx2; ang.dy[2] = dy2;
  ang.dx[3] = dx3; ang.dy[3] = dy3;
  return is_f64
             ? launch<double>(orig, lev, out, gcnt, B, H, W, ng, ang, symmetric, stream)
             : launch<float>(orig, lev, out, gcnt, B, H, W, ng, ang, symmetric, stream);
}
