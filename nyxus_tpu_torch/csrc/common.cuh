// Shared helpers of the hand-written Hopper kernels (built for sm_90a by
// nyxus_tpu_torch/_build.py into one shared library with a plain C interface).
#pragma once

#include <cuda_runtime.h>

#define NYX_BLOCK 256

// Dynamic shared memory above the default 48 KB has to be opted into per
// kernel (up to 227 KB a block on Hopper).
template <typename K>
static cudaError_t nyx_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The attributes a cluster launch of ``kernel`` needs (its dynamic shared
// memory, and a cluster of more than 8 blocks), set once per device and
// size: ``done`` is the launcher's own record (a static, one slot a
// device), since setting them before every launch costs host time.
#define NYX_DEVICES_MAX 64
struct NyxClusterAttrs {
  size_t smem[NYX_DEVICES_MAX];
  bool wide[NYX_DEVICES_MAX];
};

template <typename K>
static cudaError_t nyx_allow_cluster(K kernel, size_t bytes, int cluster,
                                     NyxClusterAttrs* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= NYX_DEVICES_MAX) return cudaErrorInvalidDevice;
  if (bytes > done->smem[dev]) {
    e = nyx_allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    done->smem[dev] = bytes;
  }
  if (cluster > 8 && !done->wide[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    done->wide[dev] = true;
  }
  return cudaSuccess;
}

// the shared::cluster address of ``p`` (this block's shared memory) in the
// shared memory of the cluster's block ``rank``, and a fire-and-forget add
// there (thread-block clusters, sm_90)
__device__ __forceinline__ unsigned int nyx_mapa(const void* p,
                                                 unsigned int rank) {
  const unsigned int l =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  unsigned int r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(l), "r"(rank));
  return r;
}

__device__ __forceinline__ void nyx_red_add(unsigned int addr,
                                            unsigned int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u32 [%0], %1;"
               ::"r"(addr), "r"(v)
               : "memory");
}
