// K1 batched_hist: out[b, k] = sum_a w[b, a] * (idx[b, a] == k), entries
// with idx outside [0, nbins) dropped.
//
// Replaces nyxus_tpu/ops/common.py:19 masked_bincount (a one-hot einsum on
// the TPU's matrix unit) and, through the composite index i * nj + j,
// common.py:62 pair_hist / :79 pair_hist_scatter.
//
// Design: one block per ROI row b; the whole histogram lives in shared
// memory (100 or 64 bins for intensity, 64 x 9 for GLDM, 65 for NGTDM: at
// most a few KB), threads stride over the row's A entries with shared-memory
// atomicAdd, then one coalesced write-out.  Bound on the card: the read of
// idx and w (8-12 bytes an entry) and shared-memory atomic contention when
// many pixels of a ROI share a bin; there is no arithmetic to speak of.
// Float sums are order-dependent (atomics); 0/1 weights give exact counts.
#include "common.cuh"

template <typename T>
__global__ void batched_hist_kernel(const int* __restrict__ idx,
                                    const T* __restrict__ w,
                                    T* __restrict__ out, int A, int nbins) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);
  const size_t b = blockIdx.x;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) hist[k] = T(0);
  __syncthreads();
  const int* ib = idx + b * A;
  const T* wb = w + b * A;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int k = ib[a];
    if (k >= 0 && k < nbins) {
      const T v = wb[a];
      if (v != T(0)) atomicAdd(&hist[k], v);
    }
  }
  __syncthreads();
  T* ob = out + b * nbins;
  for (int k = threadIdx.x; k < nbins; k += blockDim.x) ob[k] = hist[k];
}

template <typename T>
static int launch(const void* idx, const void* w, void* out, int B, int A,
                  int nbins, void* stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(nbins);
  cudaError_t e = nyx_allow_smem(batched_hist_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  batched_hist_kernel<T><<<B, NYX_BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const T*>(w),
      static_cast<T*>(out), A, nbins);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nyx_batched_hist(const void* idx, const void* w, void* out,
                                int B, int A, int nbins, int is_f64,
                                void* stream) {
  return is_f64 ? launch<double>(idx, w, out, B, A, nbins, stream)
                : launch<float>(idx, w, out, B, A, nbins, stream);
}
