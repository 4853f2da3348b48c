// K3 glrlm_runs: maximal same-level runs along 0, 45, 90 and 135 degrees,
// counted into a (level, run length) matrix per angle.
//
// Replaces nyxus_tpu/ops/glrlm.py:41 _runs_matrix_along_x, :64 _shear and
// :85 run_matrices (a reverse cumulative min over "level changes here" flags
// plus a one-hot matmul on the TPU, with the diagonals sheared into columns
// by a padded copy).  Here each thread walks one scan line directly, with no
// shear copy:
//   0 deg   rows, step (dx, dy) = (+1, 0)
//   45 deg  lines of constant x - y, step (+1, +1)
//   90 deg  columns, step (0, +1)
//   135 deg lines of constant x + y, step (-1, +1)
// which are the line sets _shear produces.  A run is a maximal stretch of
// ``valid`` pixels with equal level; it is counted at (level - 1,
// min(length, nr) - 1), levels outside 1..ng dropped.
//
// Design: one block per (ROI, angle), one thread per scan line, the
// ng x nr matrix as 32-bit integer counts in shared memory (64 x 64 = 16 KB
// for a 64 px bucket) and one coalesced write-out.  A matrix larger than a
// block's shared memory (4 * ng * nr > 227 KB: a 1024 px bucket side at 64
// levels, or 256 levels above 227 px) counts with the same atomics in a
// zeroed int32 buffer in device memory that the wrapper passes (``gcnt``,
// [B, 4, ng, nr]); each block owns its (ROI, angle) slice of it, so one
// __syncthreads() orders its counts before its own write-out.  Bound on the
// card: the per-thread serial walk (a line is at most max(H, W) pixels
// long) and its strided reads of the crop, which stay in L1/L2 (a 64 x 64
// crop is 20 KB); on the device-memory path, also the L2 atomics.
#include "common.cuh"

__device__ __forceinline__ void nyx_emit_run(unsigned int* cnt, int level,
                                             int len, int ng, int nr) {
  const int i = level - 1;
  if (i < 0 || i >= ng) return;
  const int j = (len < nr ? len : nr) - 1;
  atomicAdd(&cnt[i * nr + j], 1u);
}

template <typename T>
__global__ void glrlm_runs_kernel(const int* __restrict__ lev,
                                  const unsigned char* __restrict__ valid,
                                  T* __restrict__ out,
                                  unsigned int* __restrict__ gcnt, int H,
                                  int W, int ng, int nr) {
  extern __shared__ unsigned int smem_cnt[];
  const int b = blockIdx.x;
  const int a = blockIdx.y;  // 0: 0 deg, 1: 45 deg, 2: 90 deg, 3: 135 deg
  const int nm = ng * nr;
  unsigned int* cnt = gcnt ? gcnt + (static_cast<size_t>(b) * 4 + a) * nm
                           : smem_cnt;
  if (!gcnt) {
    for (int k = threadIdx.x; k < nm; k += blockDim.x) cnt[k] = 0u;
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(b) * H * W;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  const int nlines = (a == 0) ? H : (a == 2) ? W : H + W - 1;
  for (int line = threadIdx.x; line < nlines; line += blockDim.x) {
    int x, y, sx, sy;
    if (a == 0) {
      x = 0; y = line; sx = 1; sy = 0;
    } else if (a == 2) {
      x = line; y = 0; sx = 0; sy = 1;
    } else if (a == 1) {
      const int d = line - (H - 1);  // x - y
      x = d >= 0 ? d : 0;
      y = d >= 0 ? 0 : -d;
      sx = 1; sy = 1;
    } else {
      const int s = line;            // x + y
      y = s - (W - 1) > 0 ? s - (W - 1) : 0;
      x = s - y;
      sx = -1; sy = 1;
    }
    int cur = 0;
    int len = 0;  // 0: no open run
    while (x >= 0 && x < W && y < H) {
      const int p = y * W + x;
      if (vb[p]) {
        const int l = lb[p];
        if (len > 0 && l == cur) {
          ++len;
        } else {
          if (len > 0) nyx_emit_run(cnt, cur, len, ng, nr);
          cur = l;
          len = 1;
        }
      } else if (len > 0) {
        nyx_emit_run(cnt, cur, len, ng, nr);
        len = 0;
      }
      x += sx;
      y += sy;
    }
    if (len > 0) nyx_emit_run(cnt, cur, len, ng, nr);
  }
  __syncthreads();
  T* o = out + (static_cast<size_t>(b) * 4 + a) * nm;
  for (int k = threadIdx.x; k < nm; k += blockDim.x)
    o[k] = static_cast<T>(gcnt ? __ldcg(cnt + k) : cnt[k]);
}

template <typename T>
static int launch(const void* lev, const void* valid, void* out, void* gcnt,
                  int B, int H, int W, int ng, int nr, void* stream) {
  const size_t smem =
      gcnt ? 0 : sizeof(unsigned int) * static_cast<size_t>(ng) * nr;
  cudaError_t e = nyx_allow_smem(glrlm_runs_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, 4);
  glrlm_runs_kernel<T><<<grid, NYX_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(valid),
      static_cast<T*>(out), static_cast<unsigned int*>(gcnt), H, W, ng, nr);
  return static_cast<int>(cudaGetLastError());
}

// gcnt: NULL to count in shared memory, else a zeroed int32 [B, 4, ng, nr].
extern "C" int nyx_glrlm_runs(const void* lev, const void* valid, void* out,
                              void* gcnt, int B, int H, int W, int ng, int nr,
                              int is_f64, void* stream) {
  return is_f64 ? launch<double>(lev, valid, out, gcnt, B, H, W, ng, nr, stream)
                : launch<float>(lev, valid, out, gcnt, B, H, W, ng, nr, stream);
}
