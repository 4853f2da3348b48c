// K1 batched_hist: out[b, k] = sum_a w[b, a] * (idx[b, a] == k), entries
// with idx outside [0, nbins) dropped.
//
// Replaces nyxus_tpu/ops/common.py:19 masked_bincount (a one-hot einsum on
// the TPU's matrix unit) and, through the composite index i * nj + j,
// common.py:62 pair_hist / :79 pair_hist_scatter.
//
// Design: a grid of (ROI row b, chunk) blocks, each over ``chunk`` entries
// of its row.  Where the histogram fits a block's shared memory (100 or 64
// bins for intensity, 64 x 9 for GLDM, 65 for NGTDM: a few KB) a block
// counts there with shared-memory atomicAdd; a row of one chunk (every 2D
// bucket up to 64 x 128) then writes its bins out directly, a row of several
// chunks (3D cubes: 32^3 is four) adds its non-zero bins into the zeroed
// output with device-memory atomics.  A histogram larger than a block's
// shared memory (raw 12-bit levels: 4096 x 27 GLDM cells, 442 KB) is
// counted straight into the zeroed output with device-memory atomics.
// Bound on the card: the read of idx and w (8-12 bytes an entry) and the
// atomics on popular bins (shared memory, or L2 on the device-memory path);
// there is no arithmetic to speak of.  Float sums are order-dependent
// (atomics); 0/1 weights give exact counts.
#include "common.cuh"

template <typename T>
__global__ void batched_hist_smem(const int* __restrict__ idx,
                                  const T* __restrict__ w, T* __restrict__ out,
                                  int A, int nbins, int chunk) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);
  const size_t b = blockIdx.x;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) hist[k] = T(0);
  __syncthreads();
  const int a0 = blockIdx.y * chunk;
  const int a1 = min(A, a0 + chunk);
  const int* ib = idx + b * A;
  const T* wb = w + b * A;
  for (int a = a0 + threadIdx.x; a < a1; a += blockDim.x) {
    const int k = ib[a];
    if (k >= 0 && k < nbins) {
      const T v = wb[a];
      if (v != T(0)) atomicAdd(&hist[k], v);
    }
  }
  __syncthreads();
  T* ob = out + b * nbins;
  if (gridDim.y == 1) {
    for (int k = threadIdx.x; k < nbins; k += blockDim.x) ob[k] = hist[k];
  } else {
    for (int k = threadIdx.x; k < nbins; k += blockDim.x)
      if (hist[k] != T(0)) atomicAdd(ob + k, hist[k]);
  }
}

template <typename T>
__global__ void batched_hist_gmem(const int* __restrict__ idx,
                                  const T* __restrict__ w, T* __restrict__ out,
                                  int A, int nbins, int chunk) {
  const size_t b = blockIdx.x;
  const int a0 = blockIdx.y * chunk;
  const int a1 = min(A, a0 + chunk);
  const int* ib = idx + b * A;
  const T* wb = w + b * A;
  T* ob = out + b * nbins;
  for (int a = a0 + threadIdx.x; a < a1; a += blockDim.x) {
    const int k = ib[a];
    if (k >= 0 && k < nbins) {
      const T v = wb[a];
      if (v != T(0)) atomicAdd(ob + k, v);
    }
  }
}

template <typename T>
static int launch(const void* idx, const void* w, void* out, int B, int A,
                  int nbins, int chunk, int in_smem, void* stream) {
  const dim3 grid(B, (A + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_smem) {
    const size_t smem = sizeof(T) * static_cast<size_t>(nbins);
    cudaError_t e = nyx_allow_smem(batched_hist_smem<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    batched_hist_smem<T><<<grid, NYX_BLOCK, smem, s>>>(
        static_cast<const int*>(idx), static_cast<const T*>(w),
        static_cast<T*>(out), A, nbins, chunk);
  } else {
    batched_hist_gmem<T><<<grid, NYX_BLOCK, 0, s>>>(
        static_cast<const int*>(idx), static_cast<const T*>(w),
        static_cast<T*>(out), A, nbins, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// out must be zeroed unless in_smem and A <= chunk (one chunk a row).
extern "C" int nyx_batched_hist(const void* idx, const void* w, void* out,
                                int B, int A, int nbins, int chunk,
                                int in_smem, int is_f64, void* stream) {
  return is_f64 ? launch<double>(idx, w, out, B, A, nbins, chunk, in_smem, stream)
                : launch<float>(idx, w, out, B, A, nbins, chunk, in_smem, stream);
}
