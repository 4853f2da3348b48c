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
// Bound on the card: not bytes (the crop is read once and the labels
// written once: 9 bytes a pixel) but the H dependent row steps, each as
// long as the chain from the previous row's labels to this row's: two
// shuffles across the lane edges, the serial prefix-min of a lane's
// columns, up to five shuffle steps of the lanes' scan and the carry's
// shuffle (``zone_dag_chain`` times that chain alone, with all five
// steps, for the floor PERF.md quotes).
//
// Warp path (rows of at most 32 * NYX_DAG_COLS_MAX pixels; every bucket of
// the main path): one warp a ROI, several ROIs to a block, lane j owning
// the C consecutive columns [jC, jC + C).  The previous row's labels,
// levels and valid bits stay in registers; NW and NE across a lane edge
// come from __shfl_up_sync / __shfl_down_sync.  The levels and valid bytes
// of the next D rows (8, 16, 4 and 4 at 1, 2, 4 and 8 columns a lane) are
// loaded into a ring of registers, a lane's columns as one vector where the
// width allows, while the current row is computed, so the loads are off
// the chain.  A lane takes the segmented prefix-min of its own columns
// serially; the lanes' tails are then joined by a segmented shuffle scan
// whose segment starts are a __ballot_sync of the lanes that hold a break,
// with only as many of its five steps as the row's longest segment of
// lanes needs (a __reduce_max_sync, off the chain), and each lane's leading
// run takes its west neighbours' carry.  Each label is written once, in
// coalesced rows.  No shared memory, no block barrier.
//
// Block path (wider rows, only past 256 columns): one block per ROI with the
// labels in device memory, each thread a contiguous chunk of a row, a
// Hillis-Steele scan of the chunk summaries in shared memory and
// 2 log2(threads) + 2 barriers a row (the first design of K5).
#include "common.cuh"

#define NYX_DAG_COLS_MAX 8
#define NYX_DAG_WARPS_MAX 8

// ---------------------------------------------------------------------------
// warp path

// row ``row`` (its first pixel's index) of the lane's columns: levels and
// valid bytes, 0 beyond the crop's width; VEC (W a multiple of C): the C
// levels in one load of 4C bytes (two of 16 at C = 8) and the valid bytes
// in one of C bytes
template <int C, bool VEC>
__device__ __forceinline__ void nyx_dag_load(const int* __restrict__ lb,
                                             const unsigned char* __restrict__ vb,
                                             int row, int x0, int W,
                                             int (&l)[C], int (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) l[c] = v[c] = 0;
  if constexpr (VEC && C > 1) {
    if (x0 >= W) return;
    const int* lp = lb + row + x0;
    const unsigned char* vp = vb + row + x0;
    unsigned m0 = 0u, m1 = 0u;
    if constexpr (C == 2) {
      const int2 q = *reinterpret_cast<const int2*>(lp);
      l[0] = q.x;
      l[1] = q.y;
      m0 = *reinterpret_cast<const unsigned short*>(vp);
    } else {
#pragma unroll
      for (int g = 0; g < C / 4; ++g) {
        const int4 q = *reinterpret_cast<const int4*>(lp + 4 * g);
        l[4 * g] = q.x;
        l[4 * g + 1] = q.y;
        l[4 * g + 2] = q.z;
        l[4 * g + 3] = q.w;
      }
      if constexpr (C == 4) {
        m0 = *reinterpret_cast<const unsigned*>(vp);
      } else {
        const uint2 m = *reinterpret_cast<const uint2*>(vp);
        m0 = m.x;
        m1 = m.y;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[c] = ((c < 4 ? m0 : m1) >> (8 * (c & 3))) & 0xffu;
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (x0 + c < W) {
        l[c] = lb[row + x0 + c];
        v[c] = vb[row + x0 + c];
      }
    }
  }
}

// the previous row of a lane: labels, levels and valid bits, and across the
// lane edges the west lane's last and the east lane's first level and valid
// bit (none above row 0)
template <int C>
struct NyxDagRow {
  int pl[C], pv[C];
  unsigned pm, pwm, pem;
  int pwl, pel;
};

// one row step of the warp path: levels cl and valid bytes cv of this row
// (row: its first pixel's index) against the previous row in ``st``; this
// row's labels are written and become ``st``.  Everything that reads only
// levels and valid bits (which predecessors count, which columns join
// their west neighbour, the scan's segments and how many of its steps the
// longest segment needs) is formed first, off the chain from the previous
// row's labels to this row's.
template <int C>
__device__ __forceinline__ void nyx_dag_row(NyxDagRow<C>& st,
                                            const int (&cl)[C],
                                            const int (&cv)[C], int row,
                                            int x0, int W, int BIG, int lane,
                                            unsigned lanes_le, int* ab) {
  unsigned cm = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) cm |= (cv[c] ? 1u : 0u) << c;
  // this row across the lane edges
  const int cwl = __shfl_up_sync(NYX_FULL, cl[C - 1], 1);
  const unsigned cwm =
      __shfl_up_sync(NYX_FULL, cm >> (C - 1), 1) & (lane > 0 ? 1u : 0u);
  const int cel = __shfl_down_sync(NYX_FULL, cl[0], 1);
  const unsigned cem =
      __shfl_down_sync(NYX_FULL, cm & 1u, 1) & (lane < 31 ? 1u : 0u);
  // valid same-level NW, N and NE predecessors, and W joins, by column
  unsigned nw = 0u, nn = 0u, ne = 0u, jm = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int lv = cl[c];
    const bool ok = (cm >> c) & 1u;
    const bool a = c > 0 ? ((st.pm >> (c - 1)) & 1u) && st.pv[c - 1] == lv
                         : st.pwm && st.pwl == lv;
    const bool n = ((st.pm >> c) & 1u) && st.pv[c] == lv;
    const bool e = c < C - 1 ? ((st.pm >> (c + 1)) & 1u) && st.pv[c + 1] == lv
                             : st.pem && st.pel == lv;
    const bool j = c > 0 ? ((cm >> (c - 1)) & 1u) && cl[c - 1] == lv
                         : cwm && cwl == lv;
    nw |= (ok && a ? 1u : 0u) << c;
    nn |= (ok && n ? 1u : 0u) << c;
    ne |= (ok && e ? 1u : 0u) << c;
    jm |= (ok && j ? 1u : 0u) << c;
  }
  // a lane that holds a break starts a segment of the lanes' scan (lane 0
  // always: its column 0 joins nothing); the scan needs the steps of the
  // longest segment only
  const unsigned whole = C == 32 ? NYX_FULL : (1u << C) - 1u;
  const unsigned heads = __ballot_sync(NYX_FULL, jm != whole);
  const int seg = 31 - __clz(heads & lanes_le);
  const unsigned span =
      __reduce_max_sync(NYX_FULL, static_cast<unsigned>(lane - seg + 1));
  const unsigned lead = jm & ~(jm + 1u);  // the leading run of joins

  // the chain: the previous row's labels across the lane edges, each
  // pixel's min over itself and its predecessors, the segmented prefix-min
  // of the lane's columns, the lanes' scan and the west lanes' carry
  const int pwlab = __shfl_up_sync(NYX_FULL, st.pl[C - 1], 1);
  const int pelab = __shfl_down_sync(NYX_FULL, st.pl[0], 1);
  int cur[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int a = (nw >> c) & 1u ? (c > 0 ? st.pl[c - 1] : pwlab) : BIG;
    const int n = (nn >> c) & 1u ? st.pl[c] : BIG;
    const int e = (ne >> c) & 1u ? (c < C - 1 ? st.pl[c + 1] : pelab) : BIG;
    const int own = (cm >> c) & 1u ? row + x0 + c : BIG;
    const int v = min(min(a, n), min(e, own));
    cur[c] = ((jm >> c) & 1u) && c > 0 ? min(cur[c - 1], v) : v;
  }
  int t = cur[C - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (static_cast<unsigned>(o) < span) {  // warp-uniform
      const int n = __shfl_up_sync(NYX_FULL, t, o);
      if (lane - o >= seg) t = min(t, n);
    }
  }
  const int carry = __shfl_up_sync(NYX_FULL, t, 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if ((lead >> c) & 1u) cur[c] = min(cur[c], carry);
    if (x0 + c < W) ab[row + x0 + c] = cur[c];
    st.pl[c] = cur[c];
    st.pv[c] = cl[c];
  }
  st.pm = cm;
  st.pwl = cwl;
  st.pwm = cwm;
  st.pel = cel;
  st.pem = cem;
}

template <int C, int D, bool VEC>
__global__ void __launch_bounds__(32 * NYX_DAG_WARPS_MAX)
    zone_dag_warp(const int* __restrict__ lev,
                  const unsigned char* __restrict__ valid,
                  int* __restrict__ anc, int B, int H, int W) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const size_t base = static_cast<size_t>(b) * H * W;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  int* ab = anc + base;
  const int BIG = H * W;
  const int x0 = lane * C;
  const unsigned lanes_le = NYX_FULL >> (31 - lane);  // lanes 0..lane

  // the ring of the rows ahead: slot d holds row y with y % D == d
  int rl[D][C], rv[D][C];
#pragma unroll
  for (int d = 0; d < D; ++d)
    nyx_dag_load<C, VEC>(lb, vb, min(d, H - 1) * W, x0, W, rl[d], rv[d]);
  NyxDagRow<C> st;
#pragma unroll
  for (int c = 0; c < C; ++c) st.pl[c] = st.pv[c] = 0;
  st.pm = st.pwm = st.pem = 0u;
  st.pwl = st.pel = 0;

  // whole groups of D rows as straight-line code, so that the compiler
  // can fill one row's chain with the next rows' off-chain work (a row
  // past the last reloads the last, unused)
  int y0 = 0;
  for (; y0 + D <= H; y0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      int cl[C], cv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        cl[c] = rl[d][c];
        cv[c] = rv[d][c];
      }
      nyx_dag_load<C, VEC>(lb, vb, min(y0 + d + D, H - 1) * W, x0, W, rl[d],
                           rv[d]);
      nyx_dag_row<C>(st, cl, cv, (y0 + d) * W, x0, W, BIG, lane, lanes_le,
                     ab);
    }
  }
  // the last H % D rows
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (y0 + d < H)
      nyx_dag_row<C>(st, rl[d], rv[d], (y0 + d) * W, x0, W, BIG, lane,
                     lanes_le, ab);
}

// The warp path's dependent chain alone, for the floor PERF.md quotes: H
// row steps of the two edge shuffles, the ballot, the five-step scan and
// the carry, with no loads and one store a warp.  One warp a ROI as above.
__global__ void zone_dag_chain(int* __restrict__ out, int B, int H) {
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (b >= B) return;
  const unsigned lanes_le = NYX_FULL >> (31 - lane);
  int cur = lane;
  for (int y = 0; y < H; ++y) {
    const int w = __shfl_up_sync(NYX_FULL, cur, 1);
    const int e = __shfl_down_sync(NYX_FULL, cur, 1);
    int t = min(cur, min(w, e)) + y;
    const unsigned heads = __ballot_sync(NYX_FULL, (t & 3) == 0) | 1u;
    const int seg = 31 - __clz(heads & lanes_le);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(NYX_FULL, t, o);
      if (lane - o >= seg) t = min(t, n);
    }
    cur = min(t, __shfl_up_sync(NYX_FULL, t, 1) + 1);
  }
  if (lane == 0) out[b] = cur;
}

// ---------------------------------------------------------------------------
// block path

__device__ __forceinline__ bool nyx_joins_w(const int* lb,
                                            const unsigned char* vb, int p,
                                            int x) {
  return x > 0 && vb[p] && vb[p - 1] && lb[p - 1] == lb[p];
}

__global__ void zone_dag_block(const int* __restrict__ lev,
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

// ---------------------------------------------------------------------------

template <int C, int D>
static void launch_warp(const void* lev, const void* valid, void* anc, int B,
                        int H, int W, int R, cudaStream_t s) {
  const dim3 grid((B + R - 1) / R), block(32 * R);
  const int* l = static_cast<const int*>(lev);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  int* a = static_cast<int*>(anc);
  if constexpr (C > 1) {
    if (W % C == 0) {  // rows and lanes' columns aligned to their vectors
      zone_dag_warp<C, D, true><<<grid, block, 0, s>>>(l, v, a, B, H, W);
      return;
    }
  }
  zone_dag_warp<C, D, false><<<grid, block, 0, s>>>(l, v, a, B, H, W);
}

// path 0: the warp path, C columns a lane (1, 2, 4 or 8; 32 * C >= W), R
// ROIs (warps) a block; path 1: the block path, ``threads`` a block
// (ops/zones.py zone_dag_plan).
extern "C" int nyx_zone_dag(const void* lev, const void* valid, void* anc,
                            int B, int H, int W, int path, int C, int R,
                            int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (R < 1 || R > NYX_DAG_WARPS_MAX || 32 * C < W)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (C) {
      case 1: launch_warp<1, 8>(lev, valid, anc, B, H, W, R, s); break;
      case 2: launch_warp<2, 16>(lev, valid, anc, B, H, W, R, s); break;
      case 4: launch_warp<4, 4>(lev, valid, anc, B, H, W, R, s); break;
      case 8: launch_warp<8, 4>(lev, valid, anc, B, H, W, R, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (path == 1) {
    if (threads < 32 || threads > NYX_BLOCK || threads % 32)
      return static_cast<int>(cudaErrorInvalidValue);
    zone_dag_block<<<B, threads, 0, s>>>(
        static_cast<const int*>(lev), static_cast<const unsigned char*>(valid),
        static_cast<int*>(anc), H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: [B] int32 (one value a warp); R warps a block
extern "C" int nyx_zone_dag_chain(void* out, int B, int H, int R,
                                  void* stream) {
  if (R < 1 || R > NYX_DAG_WARPS_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  zone_dag_chain<<<(B + R - 1) / R, 32 * R, 0,
                   static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(out),
                                                        B, H);
  return static_cast<int>(cudaGetLastError());
}
