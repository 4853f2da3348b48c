// K14 glrlm3d_runs: maximal same-level runs along the 13 directions of the
// reference's 3D GLRLM, counted into a (level, run length) matrix per
// direction.
//
// Replaces nyxus_tpu/ops/texture3d.py:134 _runs3d and :157 glrlm3d_all's
// matrix build (per direction, a pointer-jumping chain length over
// log2(max dim) shifted3d copies, then a pair_hist scatter on the TPU).
// Here one thread walks one scan line: the lines of direction d = (dz, dy,
// dx) start at the voxels v of the padded [D, H, W] cube whose v - d lies
// outside it, and step by +d to the far face.  A run is a maximal stretch
// of ``valid`` voxels with equal level; it is counted at (level - 1,
// min(length, nr) - 1), levels outside 1..ng dropped (level 0 too).
//
// The start voxels of a direction are enumerated without a scan: the face
// z = 0 (or D - 1) when dz != 0, then the face y = 0 (or H - 1) of the
// remaining planes when dy != 0, then the face x = 0 (or W - 1) of the
// remaining rows when dx != 0 -- D*H*W - (D-|dz|)(H-|dy|)(W-|dx|) lines.
//
// Design: a grid of (ROI, direction, group of 1024 lines) blocks.  Where the
// ng x nr matrix fits a block's shared memory as 32-bit counts (64 x 64:
// 16 KB) each block counts there and adds its non-zero cells into a zeroed
// int32 [B, 13, ng, nr] buffer in device memory; a larger matrix (raw
// 12-bit levels: 4096 x 64, 1 MB) is counted straight into that buffer.  A
// second launch converts the counts to the compute dtype.  Counts are
// exact.  Bound on the card: the serial walk of a line (at most max(D, H,
// W) voxels) and its strided reads of the level and valid planes, which
// stay in L2; the atomics on the device-memory path.
#include "common.cuh"

#define NYX_RUNS3_LINES 1024

struct NyxSteps13 {
  int dz[13];
  int dy[13];
  int dx[13];
};

__device__ __forceinline__ void nyx_emit_run3(unsigned int* cnt, int level,
                                              int len, int ng, int nr) {
  const int i = level - 1;
  if (i < 0 || i >= ng) return;
  const int j = (len < nr ? len : nr) - 1;
  atomicAdd(&cnt[i * nr + j], 1u);
}

__global__ void glrlm3d_count_kernel(const int* __restrict__ lev,
                                     const unsigned char* __restrict__ valid,
                                     unsigned int* __restrict__ gcnt, int D,
                                     int H, int W, int ng, int nr,
                                     NyxSteps13 st, int in_smem) {
  extern __shared__ unsigned int smem_cnt[];
  const int b = blockIdx.x;
  const int a = blockIdx.y;
  const int dz = st.dz[a], dy = st.dy[a], dx = st.dx[a];
  // start faces: z, then y of the remaining planes, then x of the rest
  const int nZ = dz ? H * W : 0;
  const int zr = dz ? D - 1 : D;
  const int zlo = dz > 0 ? 1 : 0;
  const int nY = dy ? zr * W : 0;
  const int yr = dy ? H - 1 : H;
  const int ylo = dy > 0 ? 1 : 0;
  const int nX = dx ? zr * yr : 0;
  const int nlines = nZ + nY + nX;
  const int l0 = blockIdx.z * NYX_RUNS3_LINES;
  if (l0 >= nlines) return;  // the same for every thread of the block
  const int l1 = min(nlines, l0 + NYX_RUNS3_LINES);
  const int nm = ng * nr;
  unsigned int* g = gcnt + (static_cast<size_t>(b) * 13 + a) * nm;
  unsigned int* cnt = in_smem ? smem_cnt : g;
  if (in_smem) {
    for (int k = threadIdx.x; k < nm; k += blockDim.x) cnt[k] = 0u;
    __syncthreads();
  }
  const int HW = H * W;
  const size_t base = static_cast<size_t>(b) * D * HW;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  for (int t = l0 + threadIdx.x; t < l1; t += blockDim.x) {
    int z, y, x;
    if (t < nZ) {
      z = dz > 0 ? 0 : D - 1;
      y = t / W;
      x = t - y * W;
    } else if (t < nZ + nY) {
      const int u = t - nZ;
      z = zlo + u / W;
      y = dy > 0 ? 0 : H - 1;
      x = u - (u / W) * W;
    } else {
      const int u = t - nZ - nY;
      z = zlo + u / yr;
      y = ylo + (u - (u / yr) * yr);
      x = dx > 0 ? 0 : W - 1;
    }
    int cur = 0;
    int len = 0;  // 0: no open run
    while (z >= 0 && z < D && y >= 0 && y < H && x >= 0 && x < W) {
      const int p = z * HW + y * W + x;
      if (vb[p]) {
        const int l = lb[p];
        if (len > 0 && l == cur) {
          ++len;
        } else {
          if (len > 0) nyx_emit_run3(cnt, cur, len, ng, nr);
          cur = l;
          len = 1;
        }
      } else if (len > 0) {
        nyx_emit_run3(cnt, cur, len, ng, nr);
        len = 0;
      }
      z += dz;
      y += dy;
      x += dx;
    }
    if (len > 0) nyx_emit_run3(cnt, cur, len, ng, nr);
  }
  if (in_smem) {
    __syncthreads();
    for (int k = threadIdx.x; k < nm; k += blockDim.x)
      if (cnt[k]) atomicAdd(g + k, cnt[k]);
  }
}

template <typename T>
__global__ void glrlm3d_write_kernel(const unsigned int* __restrict__ gcnt,
                                     T* __restrict__ out, long long total) {
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x)
    out[t] = static_cast<T>(gcnt[t]);
}

template <typename T>
static int launch(const void* lev, const void* valid, void* out, void* gcnt,
                  int B, int D, int H, int W, int ng, int nr,
                  const NyxSteps13& st, int in_smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      in_smem ? sizeof(unsigned int) * static_cast<size_t>(ng) * nr : 0;
  cudaError_t e = nyx_allow_smem(glrlm3d_count_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the most lines any direction has: a corner direction's three faces
  const long long most = static_cast<long long>(D) * H * W -
                         static_cast<long long>(D - 1) * (H - 1) * (W - 1);
  dim3 grid(B, 13,
            static_cast<unsigned int>((most + NYX_RUNS3_LINES - 1) / NYX_RUNS3_LINES));
  glrlm3d_count_kernel<<<grid, NYX_BLOCK, smem, s>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(valid),
      static_cast<unsigned int*>(gcnt), D, H, W, ng, nr, st, in_smem);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = static_cast<long long>(B) * 13 * ng * nr;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  glrlm3d_write_kernel<T><<<static_cast<unsigned int>(blocks), NYX_BLOCK, 0, s>>>(
      static_cast<const unsigned int*>(gcnt), static_cast<T*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

// steps: host int[39], the 13 (dz, dy, dx) unit steps; gcnt: a zeroed int32
// [B, 13, ng, nr]; out: [B, 13, ng, nr] of the compute dtype.
extern "C" int nyx_glrlm3d_runs(const void* lev, const void* valid,
                                const void* steps, void* out, void* gcnt,
                                int B, int D, int H, int W, int ng, int nr,
                                int in_smem, int is_f64, void* stream) {
  NyxSteps13 st;
  const int* sh = static_cast<const int*>(steps);
  for (int a = 0; a < 13; ++a) {
    st.dz[a] = sh[3 * a];
    st.dy[a] = sh[3 * a + 1];
    st.dx[a] = sh[3 * a + 2];
  }
  return is_f64 ? launch<double>(lev, valid, out, gcnt, B, D, H, W, ng, nr, st,
                                 in_smem, stream)
                : launch<float>(lev, valid, out, gcnt, B, D, H, W, ng, nr, st,
                                in_smem, stream);
}
