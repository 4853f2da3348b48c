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
