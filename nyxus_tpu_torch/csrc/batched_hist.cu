// K1 batched_hist: out[c, b, k] = sum_a w[c, b, a] * (idx[b, a] == k),
// entries with idx outside [0, nbins) dropped, for C <= 4 channels of
// weights over one index.
//
// Replaces nyxus_tpu/ops/common.py:19 masked_bincount (a one-hot einsum on
// the TPU's matrix unit; C channels are C calls of it there) and, through
// the composite index i * nj + j, common.py:62 pair_hist / :79
// pair_hist_scatter.
//
// Bound on the card: the read of idx and the weights (4 + 4C or 4 + 8C
// bytes an entry) and the write of the bins; at the main path's sizes
// (a few thousand entries a row) a launch's fixed cost, the zeroing of the
// bins, the load latency and the shared-memory atomics.
//
// Design: one launch into an output of torch.empty (no zeroing launch, no
// device-memory atomic; the wrapper's batched_hist_plan chooses the sizes).
// A row's bins are cut into slices of L bins that fit a block's shared
// memory (one slice at the main path's sizes; raw 12-bit levels make
// GLDM's 4096 x 27 cells 442 KB), and each slice of a row is counted by a
// thread-block cluster of S blocks (S = 1, a plain launch, for rows of up
// to 4096 entries), block r taking the entries [r * chunk, (r + 1) *
// chunk) and counting those of its slice in shared memory, one copy of the
// slice a warp (or a group of warps) where ``copies`` fit, so that a
// warp's atomics meet only its own.  With S = 1 the block sums its copies
// and writes each bin once; with S > 1 the copies are summed in place, a
// cluster barrier, and block r sums its share of the slice over the
// cluster's blocks through distributed shared memory and writes each bin
// once.  A slice's blocks read all of the row's entries, so a row cut into
// slices is read once a slice (from L2 after the first); that measured
// faster than sending each entry to its bin's owner block through
// distributed shared memory (PERF.md, K1).  A thread loads four entries
// at once (16-byte loads of idx and of each channel's weights) where the
// row allows, else one, the first step's loads issued before the bins are
// zeroed and the next step's before the current one is counted, and adds
// its consecutive entries of one bin as one (a uniform region costs an
// atomic a step, not four).  Float sums are order-dependent (atomics); 0/1
// weights give exact counts.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NYX_HIST_CMAX 4
#define NYX_HIST_THREADS 1024
#define NYX_HIST_CLUSTER_MAX 8

// E entries of a row and their weights in C channels
template <typename T, int E, int C>
struct NyxHistStep {
  int k[E];
  T v[C][E];
};

template <typename T>
__device__ __forceinline__ void nyx_hist_ld(const T* p, T (&v)[1]) {
  v[0] = p[0];
}

__device__ __forceinline__ void nyx_hist_ld(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void nyx_hist_ld(const double* p, double (&v)[4]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  const double2 r = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = r.x;
  v[3] = r.y;
}

// the step at entry e (E = 4: 16-byte aligned, inside the row), or nothing
// (k = -1) at e >= a1
template <typename T, int E, int C>
__device__ __forceinline__ void nyx_hist_load(NyxHistStep<T, E, C>& s,
                                              const int* ib, const T* wb,
                                              size_t plane, int e, int a1) {
  if (e < a1) {
    if constexpr (E == 4) {
      const int4 q = *reinterpret_cast<const int4*>(ib + e);
      s.k[0] = q.x;
      s.k[1] = q.y;
      s.k[2] = q.z;
      s.k[3] = q.w;
    } else {
      s.k[0] = ib[e];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) nyx_hist_ld(wb + c * plane + e, s.v[c]);
  } else {
#pragma unroll
    for (int u = 0; u < E; ++u) {
      s.k[u] = -1;
#pragma unroll
      for (int c = 0; c < C; ++c) s.v[c][u] = T(0);
    }
  }
}

// the step's entries of bins [lo, lo + n) into h (channel c at c * stride):
// a run of the thread's consecutive entries in one bin is added once, at
// its last entry (which entries add depends on the keys alone)
template <typename T, int E, int C>
__device__ __forceinline__ void nyx_hist_add(const NyxHistStep<T, E, C>& s,
                                             T* h, int lo, int n,
                                             int stride) {
  T run[C];
#pragma unroll
  for (int u = 0; u < E; ++u) {
    const bool cont = u > 0 && s.k[u] == s.k[u - 1];
#pragma unroll
    for (int c = 0; c < C; ++c)
      run[c] = cont ? run[c] + s.v[c][u] : s.v[c][u];
    const bool last = u == E - 1 || s.k[u + (u < E - 1 ? 1 : 0)] != s.k[u];
    const unsigned q = static_cast<unsigned>(s.k[u] - lo);
    if (last && q < static_cast<unsigned>(n)) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (run[c] != T(0)) atomicAdd(h + c * stride + q, run[c]);
    }
  }
}

// the entries [a0, a1) of a row, E a thread and step, into bins [lo, lo +
// n) of h; ``zero`` cells of ``hist`` are zeroed (and a barrier passed)
// while the first step's loads are in flight
template <typename T, int E, int C>
__device__ __forceinline__ void nyx_hist_count(const int* ib, const T* wb,
                                               size_t plane, int a0, int a1,
                                               T* hist, int zero, T* h,
                                               int lo, int n, int stride) {
  const int step = E * blockDim.x;
  NyxHistStep<T, E, C> cur;
  int e = a0 + E * threadIdx.x;
  nyx_hist_load(cur, ib, wb, plane, e, a1);
  for (int k = threadIdx.x; k < zero; k += blockDim.x) hist[k] = T(0);
  __syncthreads();
  for (int ew = a0 + E * (threadIdx.x & ~31); ew < a1; ew += step) {
    NyxHistStep<T, E, C> next;
    e += step;
    nyx_hist_load(next, ib, wb, plane, e, a1);
    nyx_hist_add(cur, h, lo, n, stride);
    cur = next;
  }
}

// block (row b, bin slice sb, cluster rank r): the entries [r * chunk, (r +
// 1) * chunk) of row b that fall into bins [sb * L, sb * L + L), counted in
// ``copies`` copies of C x L bins, then written once (S = 1) or summed over
// the cluster's S blocks through distributed shared memory, block r
// writing its share of the slice once
template <typename T, int E, int C>
__global__ void __launch_bounds__(NYX_HIST_THREADS)
    batched_hist_kernel(const int* __restrict__ idx, const T* __restrict__ w,
                        T* __restrict__ out, int B, int A, int nbins, int S,
                        int chunk, int copies, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);
  const int Sb = (nbins + L - 1) / L;
  const int rank = static_cast<int>(blockIdx.x % S);  // the cluster rank
  const int sb = static_cast<int>((blockIdx.x / S) % Sb);
  const size_t b = blockIdx.x / S / Sb;
  const int lo = sb * L;
  const int n = min(L, nbins - lo);
  const int a0 = min(A, rank * chunk);
  const int a1 = min(A, a0 + chunk);
  const int cn = C * L;
  T* h = hist + ((threadIdx.x >> 5) & (copies - 1)) * cn;
  nyx_hist_count<T, E, C>(idx + b * A, w + b * A,
                          static_cast<size_t>(B) * A, a0, a1, hist,
                          copies * cn, h, lo, n, L);
  __syncthreads();
  T* ob = out + b * nbins + lo;  // channel c at c * B * nbins
  const size_t plane = static_cast<size_t>(B) * nbins;
  if (S == 1) {
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      const int c = i / L;
      const int j = i - c * L;
      if (j >= n) continue;
      T sum = hist[i];
      for (int p = 1; p < copies; ++p) sum += hist[p * cn + i];
      ob[c * plane + j] = sum;
    }
    return;
  }
  // several blocks a row: each block's copies summed into its copy 0, then
  // block r sums its share of the slice over the cluster's blocks
  if (copies > 1) {
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      T sum = hist[i];
      for (int p = 1; p < copies; ++p) sum += hist[p * cn + i];
      hist[i] = sum;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int Lr = (n + S - 1) / S;
  const int rlo = rank * Lr;
  const int rn = min(n - rlo, Lr);
  for (int i = threadIdx.x; i < C * Lr; i += blockDim.x) {
    const int c = i / Lr;
    const int j = i - c * Lr;
    if (j >= rn) continue;
    T sum = T(0);
    for (int r = 0; r < S; ++r)
      sum += *cluster.map_shared_rank(hist + c * L + rlo + j, r);
    ob[c * plane + rlo + j] = sum;
  }
  cluster.sync();  // no block's shared memory goes while others read it
}

template <typename T, int E, int C>
static int launch_c(const void* idx, const void* w, void* out, int B, int A,
                    int nbins, int S, int chunk, int threads, int copies,
                    int L, cudaStream_t s) {
  static NyxClusterAttrs attrs;
  auto kern = batched_hist_kernel<T, E, C>;
  const long long Sb = (static_cast<long long>(nbins) + L - 1) / L;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B * Sb * S), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(T) * static_cast<size_t>(copies) * C * L;
  cfg.stream = s;
  if (cfg.dynamicSmemBytes > 232448 || S > NYX_HIST_CLUSTER_MAX ||
      static_cast<long long>(S) * chunk < A || copies < 1 ||
      (copies & (copies - 1)) || copies > threads / 32 ||
      B * Sb * S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = nyx_allow_cluster(kern, cfg.dynamicSmemBytes, S, &attrs);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  if (S > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned int>(S);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const int*>(idx),
                         static_cast<const T*>(w), static_cast<T*>(out), B, A,
                         nbins, S, chunk, copies, L);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
static int launch_e(const void* idx, const void* w, void* out, int B, int A,
                    int nbins, int C, int S, int chunk, int threads,
                    int copies, int L, cudaStream_t s) {
  switch (C) {
    case 1: return launch_c<T, E, 1>(idx, w, out, B, A, nbins, S, chunk,
                                     threads, copies, L, s);
    case 2: return launch_c<T, E, 2>(idx, w, out, B, A, nbins, S, chunk,
                                     threads, copies, L, s);
    case 3: return launch_c<T, E, 3>(idx, w, out, B, A, nbins, S, chunk,
                                     threads, copies, L, s);
    case 4: return launch_c<T, E, 4>(idx, w, out, B, A, nbins, S, chunk,
                                     threads, copies, L, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// idx: [B, A] int32; w: [C, B, A]; out: [C, B, nbins] of w's type, every
// bin written.  A row is ceil(nbins / L) slices of L bins, each counted by
// S blocks (a cluster when S > 1) of ``chunk`` entries, ``copies`` of the
// slice's bins a block.  vec: 16-byte loads (A and chunk multiples of 4,
// idx and w 16-byte aligned) (ops/common.py batched_hist_plan).
extern "C" int nyx_batched_hist(const void* idx, const void* w, void* out,
                                int B, int A, int nbins, int C, int S,
                                int chunk, int threads, int copies, int L,
                                int vec, int is_f64, void* stream) {
  if (C < 1 || C > NYX_HIST_CMAX || S < 1 || threads < 32 ||
      threads > NYX_HIST_THREADS || threads % 32 || chunk < 1 || L < 1 ||
      (vec && (A % 4 || chunk % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return vec ? launch_e<double, 4>(idx, w, out, B, A, nbins, C, S, chunk,
                                     threads, copies, L, s)
               : launch_e<double, 1>(idx, w, out, B, A, nbins, C, S, chunk,
                                     threads, copies, L, s);
  return vec ? launch_e<float, 4>(idx, w, out, B, A, nbins, C, S, chunk,
                                  threads, copies, L, s)
             : launch_e<float, 1>(idx, w, out, B, A, nbins, C, S, chunk,
                                  threads, copies, L, s);
}
