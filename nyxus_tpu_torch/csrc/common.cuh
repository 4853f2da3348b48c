// Shared helpers of the hand-written Hopper kernels (built for sm_90a by
// nyxus_tpu_torch/_build.py into one shared library with a plain C interface).
#pragma once

#include <cuda_runtime.h>

#define NYX_BLOCK 256

// Dynamic shared memory that takes a block past the default 48 KB (with
// the kernel's static_bytes) has to be opted into per kernel (up to 227 KB
// a block on Hopper).
template <typename K>
static cudaError_t nyx_allow_smem(K kernel, size_t bytes,
                                  size_t static_bytes = 0) {
  if (bytes + static_bytes <= 48 * 1024) return cudaSuccess;
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
                                     NyxClusterAttrs* done,
                                     size_t static_bytes = 0) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= NYX_DEVICES_MAX) return cudaErrorInvalidDevice;
  if (bytes > done->smem[dev]) {
    e = nyx_allow_smem(kernel, bytes, static_bytes);
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
// or signed min there (thread-block clusters, sm_90)
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

__device__ __forceinline__ void nyx_red_min(unsigned int addr, int v) {
  asm volatile("red.relaxed.cluster.shared::cluster.min.s32 [%0], %1;"
               ::"r"(addr), "r"(v)
               : "memory");
}

// union-find over parents in the cluster's distributed shared memory: a
// relaxed load and store at a shared::cluster address, and a
// compare-and-swap there returning the value before it, of 32-bit and of
// 16-bit parents
__device__ __forceinline__ unsigned int nyx_ld_cluster32(unsigned int addr) {
  unsigned int v;
  asm volatile("ld.relaxed.cluster.shared::cluster.u32 %0, [%1];"
               : "=r"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned short nyx_ld_cluster16(
    unsigned int addr) {
  unsigned short v;
  asm volatile("ld.relaxed.cluster.shared::cluster.u16 %0, [%1];"
               : "=h"(v)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void nyx_st_cluster32(unsigned int addr,
                                                 unsigned int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;"
               ::"r"(addr), "r"(v)
               : "memory");
}

__device__ __forceinline__ void nyx_st_cluster16(unsigned int addr,
                                                 unsigned short v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u16 [%0], %1;"
               ::"r"(addr), "h"(v)
               : "memory");
}

__device__ __forceinline__ unsigned int nyx_atom_cas_cluster(
    unsigned int addr, unsigned int cmp, unsigned int v) {
  unsigned int old;
  asm volatile(
      "atom.relaxed.cluster.shared::cluster.cas.b32 %0, [%1], %2, %3;"
      : "=r"(old)
      : "r"(addr), "r"(cmp), "r"(v)
      : "memory");
  return old;
}

__device__ __forceinline__ unsigned short nyx_atom_cas16_cluster(
    unsigned int addr, unsigned short cmp, unsigned short v) {
  unsigned short old;
  asm volatile(
      "atom.relaxed.cluster.shared::cluster.cas.b16 %0, [%1], %2, %3;"
      : "=h"(old)
      : "r"(addr), "h"(cmp), "h"(v)
      : "memory");
  return old;
}

// The XOR mask of a count matrix's word swizzle (K2, K13).  A matrix row of
// ng cells is rw words (narrow: two cells a word, when ng is even), and a
// cell's word is XOR-ed within its row with the row's index masked to the
// largest power of two (up to 32) dividing rw, so that one centre level's
// cells in different rows fall in different banks (unswizzled, a cell's
// bank would follow its centre level alone, and a warp's atomics would
// conflict); mask 0 (no swizzle) where the rows do not divide into words.
__device__ __forceinline__ int nyx_swizzle_mask(int ng, bool narrow) {
  if (narrow && (ng & 1)) return 0;
  const int rw = narrow ? ng / 2 : ng;
  return min(rw & -rw, 32) - 1;
}

// warp scans: the inclusive max over lanes 0..lane, and the min over lanes
// lane..31
#define NYX_FULL 0xffffffffu

__device__ __forceinline__ int nyx_scan_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(NYX_FULL, v, o);
    if (lane >= o) v = max(v, n);
  }
  return v;
}

__device__ __forceinline__ int nyx_scan_min_rev(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_down_sync(NYX_FULL, v, o);
    if (lane + o < 32) v = min(v, n);
  }
  return v;
}

// asynchronous copies of 16 or 4 bytes into shared memory (cp.async)
__device__ __forceinline__ void nyx_cp16(void* dst, const void* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void nyx_cp4(void* dst, const void* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void nyx_cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp reduce-scatter of N float64 sums, N a power of two: each step swaps
// half of what a lane holds with the lane OFF away and adds the half it
// keeps, so the warp takes N / 2 + N / 4 + ... shuffles a lane where N
// shuffle trees take 5 N.  Afterwards v[0 .. max(N / 32, 1)) hold the
// warp's totals of sums [base, ...), base returned.  Below 32 sums the last
// steps are butterflies: lanes that differ only in their low 5 - log2(N)
// bits hold the same totals.
template <int N, int OFF = 16>
__device__ __forceinline__ int nyx_reduce_scatter(double* v, int lane) {
  if constexpr (OFF == 0) {
    return 0;
  } else if constexpr (N == 1) {
    v[0] += __shfl_xor_sync(NYX_FULL, v[0], OFF);
    return nyx_reduce_scatter<1, OFF / 2>(v, lane);
  } else {
    constexpr int h = N / 2;
    const bool hi = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const double give = hi ? v[i] : v[i + h];
      const double keep = hi ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(NYX_FULL, give, OFF);
    }
    return (hi ? h : 0) + nyx_reduce_scatter<h, OFF / 2>(v, lane);
  }
}

// The block's totals of the N float64 sums each thread holds in v: a warp
// reduce-scatter, the warps' totals through red ([warps][N] doubles of
// shared memory), then thread k < N adds sum k over the warps in warp order
// into out[k].  blockDim.x is a multiple of 32.  The caller synchronises
// before out is read, and before red is written again.
template <int N>
__device__ __forceinline__ void nyx_block_sums(double* v, double* red,
                                               double* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = nyx_reduce_scatter<N>(v, lane);
  bool owner = true;
  if constexpr (N < 32) owner = (lane & (32 / N - 1)) == 0;
  if (owner) {
#pragma unroll
    for (int i = 0; i < (N >= 32 ? N / 32 : 1); ++i)
      red[warp * N + base + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double s = 0.0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// 0/1 bytes to bits (K8's and K9's bit rows): 4 bytes -> 4 bits (byte j
// to bit j), the products of the bytes' low bits with 0x01020408 meeting,
// without carries, in bits 24..27; 16 bytes -> 16 bits
__device__ __forceinline__ unsigned int nyx_pack4(unsigned int v) {
  return ((v & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned int nyx_pack16(uint4 v) {
  return nyx_pack4(v.x) | (nyx_pack4(v.y) << 4) | (nyx_pack4(v.z) << 8) |
         (nyx_pack4(v.w) << 12);
}
