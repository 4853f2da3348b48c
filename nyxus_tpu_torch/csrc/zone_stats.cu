// K7 zone_stats: per-zone grey level, size and (GLDZM) minimum distance.
//
// Replaces nyxus_tpu/ops/zones.py:140 zone_list (one lax.sort of the
// [B, A] labels with the levels and distances as payload, then run
// boundaries found by scans on the TPU).  No sort here: every valid pixel
// adds one to its zone's size (atomicAdd at the zone's seed) and lowers the
// zone's distance (atomicMin), and the level is read at the seed.  The
// output is [B, A] arrays in RASTER ORDER OF THE SEEDS: position p holds
// zone p when ``ok[p]`` (p is valid and its own label), and zeros
// elsewhere.  JAX returns the same zones in sorted-label order, which is
// the same order with the gaps squeezed out; the feature code only sums
// over zones.
//
// Design: one block per ROI (so the reset, the atomics and the write-out of
// one ROI are ordered by __syncthreads() alone), threads striding over the
// ROI's A pixels; the counters are the output buffers in device memory.
// Bound on the card: bytes (13-17 read, 13-17 written a pixel) and the L2
// atomics on popular zones (a large uniform zone sends every pixel to one
// address).
#include "common.cuh"

__global__ void zone_stats_kernel(const int* __restrict__ anc,
                                  const int* __restrict__ lev,
                                  const unsigned char* __restrict__ valid,
                                  const int* __restrict__ dist,
                                  int* __restrict__ zlev,
                                  int* __restrict__ zsize,
                                  int* __restrict__ zdist,
                                  unsigned char* __restrict__ ok, int A) {
  const size_t base = static_cast<size_t>(blockIdx.x) * A;
  const int* ab = anc + base;
  const unsigned char* vb = valid + base;
  int* sb = zsize + base;
  int* db = dist ? zdist + base : nullptr;
  for (int p = threadIdx.x; p < A; p += blockDim.x) {
    sb[p] = 0;
    if (db) db[p] = 1 << 30;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < A; p += blockDim.x) {
    if (!vb[p]) continue;
    const int r = ab[p];
    if (r < 0 || r >= A) continue;
    atomicAdd(sb + r, 1);
    if (db) atomicMin(db + r, dist[base + p]);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < A; p += blockDim.x) {
    const bool seed = vb[p] && ab[p] == p;
    ok[base + p] = seed;
    zlev[base + p] = seed ? lev[base + p] : 0;
    if (!seed) {
      sb[p] = 0;
      if (db) db[p] = 0;
    }
  }
}

// dist and zdist are both NULL, or both given.
extern "C" int nyx_zone_stats(const void* anc, const void* lev,
                              const void* valid, const void* dist, void* zlev,
                              void* zsize, void* zdist, void* ok, int B, int A,
                              void* stream) {
  zone_stats_kernel<<<B, NYX_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(anc), static_cast<const int*>(lev),
      static_cast<const unsigned char*>(valid), static_cast<const int*>(dist),
      static_cast<int*>(zlev), static_cast<int*>(zsize),
      static_cast<int*>(zdist), static_cast<unsigned char*>(ok), A);
  return static_cast<int>(cudaGetLastError());
}
