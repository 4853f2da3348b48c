// K5 zone_dag: GLSZM zone labels.  The zone of a pixel is its lowest
// raster-index ancestor in the DAG whose edges are E, SE, S and SW steps
// between valid pixels of equal level (the reference's forward zone scan);
// pixels off ``valid`` get BIG = H * W.
//
// Replaces nyxus_tpu/ops/zones.py:32 zone_labels (a lax.while_loop that
// alternates vertical pulls and a segmented prefix-min along x until
// nothing changes).  Every predecessor of a pixel (W, NW, N, NE) comes
// earlier in raster order, so one top-to-bottom sweep is exact: row y takes,
// for each pixel, the min of its own index and the finished labels of its
// same-level valid NW, N and NE neighbours in row y - 1, then a segmented
// prefix-min along the row, where a segment is a run joined by same-level
// W edges.
//
// Design: one block per ROI.  The labels live in the output buffer in device
// memory, so the same kernel serves every bucket from 8 x 8 to 8192 x 8192
// and rectangular ones (a 256 x 256 crop of int32 labels is already more
// than a block's shared memory).  Each thread owns a contiguous chunk of a
// row: a serial segmented min inside the chunk, a Hillis-Steele scan of the
// chunk summaries (value, "the whole chunk joins its west neighbour") in
// shared memory, and a carry into the chunk's leading segment.
// __syncthreads() between rows.  Bound on the card: the H dependent row
// steps (each a few barriers and a log2(threads) scan), not bytes: the crop
// is read once and the labels written about twice.
#include "common.cuh"

__device__ __forceinline__ bool nyx_joins_w(const int* lb,
                                            const unsigned char* vb, int p,
                                            int x) {
  return x > 0 && vb[p] && vb[p - 1] && lb[p - 1] == lb[p];
}

__global__ void zone_dag_kernel(const int* __restrict__ lev,
                                const unsigned char* __restrict__ valid,
                                int* __restrict__ anc, int H, int W) {
  __shared__ int sv[NYX_BLOCK];
  __shared__ unsigned char sc[NYX_BLOCK];
  const size_t base = static_cast<size_t>(blockIdx.x) * H * W;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  int* ab = anc + base;
  const int BIG = H * W;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int C = (W + T - 1) / T;
  const int x0 = min(t * C, W);
  const int x1 = min(x0 + C, W);
  for (int y = 0; y < H; ++y) {
    const int row = y * W;
    // 1. seed values and the segmented min inside the chunk
    int cur = BIG;
    bool all = true;  // every element of the chunk joins its west neighbour
    for (int x = x0; x < x1; ++x) {
      const int p = row + x;
      int v = BIG;
      if (vb[p]) {
        const int l = lb[p];
        v = p;
        if (y > 0) {
          for (int dx = -1; dx <= 1; ++dx) {
            const int nx = x + dx;
            if (nx < 0 || nx >= W) continue;
            const int q = p - W + dx;
            if (vb[q] && lb[q] == l) v = min(v, ab[q]);
          }
        }
      }
      const bool joins = nyx_joins_w(lb, vb, p, x);
      cur = (joins && x > x0) ? min(cur, v) : v;
      all = all && joins;
      ab[p] = cur;
    }
    // an empty chunk is the identity (BIG, joins)
    sv[t] = cur;
    sc[t] = all;
    __syncthreads();
    // 2. inclusive scan of (value, joins) over the chunks:
    //    (l, r) -> (r.joins ? min(l.value, r.value) : r.value, l.joins & r.joins)
    for (int k = 1; k < T; k <<= 1) {
      int pv = BIG;
      unsigned char pc = 0;
      if (t >= k) {
        pv = sv[t - k];
        pc = sc[t - k];
      }
      __syncthreads();
      if (t >= k) {
        if (sc[t]) sv[t] = min(sv[t], pv);
        sc[t] = sc[t] & pc;
      }
      __syncthreads();
    }
    // 3. carry the west chunks' value into this chunk's leading segment
    const int carry = t > 0 ? sv[t - 1] : BIG;
    if (carry < BIG) {
      for (int x = x0; x < x1; ++x) {
        const int p = row + x;
        if (!nyx_joins_w(lb, vb, p, x)) break;
        ab[p] = min(ab[p], carry);
      }
    }
    __syncthreads();
  }
}

extern "C" int nyx_zone_dag(const void* lev, const void* valid, void* anc,
                            int B, int H, int W, void* stream) {
  int threads = 32;
  while (threads < W && threads < NYX_BLOCK) threads <<= 1;
  zone_dag_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(valid),
      static_cast<int*>(anc), H, W);
  return static_cast<int>(cudaGetLastError());
}
