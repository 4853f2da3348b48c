// K8 erosion: EROSIONS_2_VANISH, the number of 3x3-cross erosions of the
// AABB interior before it is empty.
//
// Replaces nyxus_tpu/ops/binary.py:27 erosions_to_vanish, a lax.while_loop
// over the whole batch on the TPU that runs until the slowest ROI is done
// (every step erodes every crop of the bucket).  Here each ROI exits on its
// own.  Semantics are binary.py:46-61 exactly: a step writes
// min(centre, N, S, W, E) at the interior pixels 2 <= x <= w-2,
// 2 <= y <= h-2 and leaves every other pixel frozen at its mask value; the
// step that empties the interior is not counted, and the count stops at
// EROSION_CAP = 1000 (erosion.h:42).  An interior pixel reads only pixels of
// its AABB, so bucket padding never enters.
//
// Design of the warp and block paths: the mask is packed into bit rows
// (bit x of a row's word is pixel x, 16 bytes at a time where rows are
// 16-byte multiples), and a step on a row's word is
//   next = cur & (up & down & (cur << 1) & (cur >> 1) | ~interior)
// with ``interior`` the word's columns 2..w-2 on rows 2..h-2 and zero on
// the other rows; the interior is alive while any next & interior is set.
// A step that changes nothing leaves the interior as it is for good, so
// the count is then the cap (a full AABB, whose frozen border feeds the
// interior, stops there at once).  Three paths (ops/binary.py
// erosion_plan), the first two so:
// - "warp": W <= 64 and H <= 128; a warp a ROI (a block of 32 threads),
//   lane l holding rows [l K, l K + K) as 32- or 64-bit words in registers
//   (K = 1, 2 or 4, the power of two >= H / 32); a step is two shuffles
//   (the rows above and below the lane's), the bit operations and two
//   votes: no block barrier.  Past 128 rows a lane's serial rows and loads
//   made it slower than the block path.
// - "block": a block a ROI, two bit planes of H x ceil(W / 64) words in
//   shared memory, a thread a column of words (every RP-th row), one
//   barrier a step that reduces the changed flag: the step after the one
//   that empties the interior changes nothing, and the count is read off
//   that step's number (one step more than the warp path runs).
// - "dist": past the block path (ops/binary.py erosion_plan), no chain of
//   steps at all: the count is a city-block distance transform.  Let I be
//   the interior (rows 2..h-2 x columns 2..w-2) and S the sources: the
//   pixels of I whose mask is 0, and the frame pixels 4-adjacent to I
//   whose mask is 0 (rows 1 and h-1 at columns 2..w-2, columns 1 and w-1
//   at rows 2..h-2; not the corners, not row 0 or column 0).  With
//   T = max over p in I of min over s in S of |dy| + |dx|, the count is 0
//   when I is empty, CAP when S is empty, else min(max(T - 1, 0), CAP).
//   Proof sketch: a step turns an interior 1 to 0 exactly when a 4-
//   neighbour is 0, and a frozen pixel never changes, so after k steps an
//   interior pixel is 0 exactly when a source lies within k steps of it
//   along a path through I; I is a rectangle, so a shortest city-block
//   path from any source to a pixel of I can stay inside I (a frame source
//   enters I through its one neighbour there), and that distance is
//   |dy| + |dx|.  The interior is first empty at step T, which the loop
//   does not count: T - 1 counted steps.  The transform is two line passes
//   and a max, in two launches, over each ROI's AABB only: a warp a row
//   takes each pixel's distance to the nearest source along its row (the
//   sources of a 32-column chunk one ballot), clamped at CAP + 1 (which
//   leaves the count as it was) into an int16 plane; then a block of 32 x
//   32 threads a ROI and 32 columns runs the column min-plus scans, each
//   thread over a segment of rows with the segments' carries in shared
//   memory, and raises the ROI's count with one atomicMax a warp.
// Bound on the card: the warp and block paths run dependent steps (about
// the ROI's inradius of them); the bytes bound, the mask read once, is what
// the dist path aims at.
#include "common.cuh"

#define NYX_EROSION_CAP 1000

// bits of columns 2..w-2 in a word of B bits holding columns [x0, x0 + B)
template <typename U>
__device__ __forceinline__ U ero_cols(int x0, int w) {
  constexpr int BITS = 8 * sizeof(U);
  const int lo = max(2, x0) - x0;
  const int hi = min(w - 2, x0 + BITS - 1) - x0;  // inclusive
  if (hi < lo) return U(0);
  const U upto = hi >= BITS - 1 ? ~U(0) : ((U(1) << (hi + 1)) - U(1));
  return upto & ~((U(1) << lo) - U(1));
}

// ---------------------------------------------------------------------------
// "warp": a warp a ROI, K rows a lane in registers

template <typename U, int K, bool VEC>
__global__ void erosion_warp_kernel(const unsigned char* __restrict__ mask,
                                    const int* __restrict__ heights,
                                    const int* __restrict__ widths,
                                    int* __restrict__ out, int H, int W) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const unsigned char* m = mask + static_cast<size_t>(b) * H * W;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  U cur[K];
  if (VEC) {  // W is a multiple of 16 and every row 16-byte aligned
    constexpr int QMAX = sizeof(U) / 2;  // 16-byte parts a row at most
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int y = lane * K + k;
      U r = U(0);
      if (y < H) {
        const uint4* p = reinterpret_cast<const uint4*>(m + y * W);
#pragma unroll
        for (int q = 0; q < QMAX; ++q)
          if (q < W / 16)
            r |= static_cast<U>(nyx_pack16(__ldg(p + q))) << (16 * q);
      }
      cur[k] = r;
    }
  } else {  // a row a ballot (two past 32 columns), kept by its lane
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cur[k] = U(0);
      for (int l = 0; l < 32; ++l) {
        const int y = l * K + k;
        if (y >= H) break;
        U r = __ballot_sync(NYX_FULL, lane < W && m[y * W + lane]);
        if constexpr (sizeof(U) == 8)
          r |= static_cast<U>(__ballot_sync(
                   NYX_FULL, lane + 32 < W && m[y * W + lane + 32]))
               << 32;
        if (lane == l) cur[k] = r;
      }
    }
  }
  const U cols = ero_cols<U>(0, w);
  unsigned int rows = 0u;  // bit k: row lane K + k is an interior row
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int y = lane * K + k;
    if (y >= 2 && y <= h - 2) rows |= 1u << k;
  }
  int n = 0;
  while (true) {
    const U above = __shfl_up_sync(NYX_FULL, cur[K - 1], 1);
    const U below = __shfl_down_sync(NYX_FULL, cur[0], 1);
    U prev = above, alive = U(0), gone = U(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const U im = ((rows >> k) & 1u) ? cols : U(0);
      const U c = cur[k];
      const U dn = k + 1 < K ? cur[k + 1] : below;
      const U nv = c & ((prev & dn & (c << 1) & (c >> 1)) | ~im);
      prev = c;
      gone |= c ^ nv;
      alive |= nv & im;
      cur[k] = nv;
    }
    if (!__any_sync(NYX_FULL, alive != U(0))) break;
    if (!__any_sync(NYX_FULL, gone != U(0))) {
      n = NYX_EROSION_CAP;  // a fixed point: alive at every later step
      break;
    }
    if (++n >= NYX_EROSION_CAP) break;
  }
  if (lane == 0) out[b] = n;
}

// ---------------------------------------------------------------------------
// "block": a block a ROI, the bit planes in shared memory

template <bool VEC>
__global__ void erosion_block_kernel(const unsigned char* __restrict__ mask,
                                     const int* __restrict__ heights,
                                     const int* __restrict__ widths,
                                     int* __restrict__ out, int H, int W,
                                     int NW) {
  extern __shared__ __align__(16) unsigned long long ero_planes[];
  using U = unsigned long long;
  const int b = blockIdx.x;
  U* cur = ero_planes;
  U* nxt = ero_planes + H * NW;
  const unsigned char* m = mask + static_cast<size_t>(b) * H * W;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  // thread (y0, j): word j of rows y0, y0 + RP, ...; threads past RP x NW
  // hold no word
  const int RP = blockDim.x / NW;
  const int y0 = threadIdx.x / NW;
  const int j = threadIdx.x - y0 * NW;
  const bool on = y0 < RP;
  const int x0 = 64 * j;
  if (on) {
    const int nx = min(64, W - x0);
    for (int y = y0; y < H; y += RP) {
      U r = 0ull;
      if (VEC) {  // W a multiple of 16, rows 16-byte aligned
        const uint4* p = reinterpret_cast<const uint4*>(m + y * W + x0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nx / 16)
            r |= static_cast<U>(nyx_pack16(__ldg(p + q))) << (16 * q);
      } else {
        for (int q = 0; q < nx; ++q)
          r |= static_cast<U>(m[y * W + x0 + q] != 0) << q;
      }
      cur[y * NW + j] = r;
      nxt[y * NW + j] = r;  // the frozen words read the same in both planes
    }
  }
  __syncthreads();
  const U im = on ? ero_cols<U>(x0, w) : 0ull;
  int ys = y0;  // this thread's first interior row
  while (ys < 2) ys += RP;
  int n = 0;
  for (int step = 1;; ++step) {
    bool alive = false, gone = false;
    if (im) {
      for (int y = ys; y <= h - 2; y += RP) {
        const int i = y * NW + j;
        const U c = cur[i];
        const U lw = j ? cur[i - 1] : 0ull;
        const U rw = j + 1 < NW ? cur[i + 1] : 0ull;
        const U nv = c & ((cur[i - NW] & cur[i + NW] & ((c << 1) | (lw >> 63)) &
                           ((c >> 1) | (rw << 63))) |
                          ~im);
        nxt[i] = nv;
        alive |= (nv & im) != 0ull;
        gone |= nv != c;
      }
    }
    // one barrier a step, which also tells whether anything changed: a
    // step that changes nothing follows the step that emptied the interior
    // (or the interior never empties, and the count is the cap)
    if (!__syncthreads_or(gone)) {
      n = __syncthreads_or(alive) ? NYX_EROSION_CAP : max(0, step - 2);
      break;
    }
    if (step > NYX_EROSION_CAP) {
      n = NYX_EROSION_CAP;
      break;
    }
    U* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (threadIdx.x == 0) out[b] = n;
}

// ---------------------------------------------------------------------------
// "dist": the count as a city-block distance transform, two launches

// distances are clamped here: min(T, FAR) gives the same count as T
#define NYX_ERO_FAR (NYX_EROSION_CAP + 1)
#define NYX_ERO_NEG (-(1 << 24))
#define NYX_ERO_POS (1 << 24)

// Pass 1, rows: a warp a row y = 1 .. h-1 of a ROI, over columns 1 .. w-1.
// A chunk of 32 columns is one ballot of its sources; a backward sweep
// keeps each chunk's ballot and the first source past the chunk in shared
// memory (2 NC ints a warp, NC = ceil(W / 32)), then a forward sweep takes
// the nearest source on either side from them and writes min(left, right,
// FAR) into the int16 plane g at the interior columns 2 .. w-2.  Block
// (0, b) zeroes out[b], which pass 2 raises with atomicMax.
__global__ void erosion_rows_kernel(const unsigned char* __restrict__ mask,
                                    const int* __restrict__ heights,
                                    const int* __restrict__ widths,
                                    short* __restrict__ g,
                                    int* __restrict__ out, int H, int W) {
  extern __shared__ int ero_chunks[];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NC = (W + 31) / 32;
  unsigned int* bits = reinterpret_cast<unsigned int*>(ero_chunks) +
                       2 * NC * warp;
  int* next = reinterpret_cast<int*>(bits + NC);
  if (blockIdx.x == 0 && threadIdx.x == 0) out[b] = 0;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  const int y = 1 + blockIdx.x * (blockDim.x >> 5) + warp;
  if (h < 4 || w < 4 || y > h - 1) return;
  const size_t off =
      static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W;
  const unsigned char* m = mask + off;
  short* gr = g + off;
  // the frame rows' corners (columns 1 and w-1) are no sources
  const bool frame_row = y == 1 || y == h - 1;
  const int nc = (w - 1 + 31) / 32;  // chunks over columns 1 .. w-1
  int carry = NYX_ERO_POS;           // the first source past the chunk
  for (int c = nc - 1; c >= 0; --c) {
    const int x = 1 + 32 * c + lane;
    const bool src = x < w && __ldg(m + x) == 0 &&
                     !(frame_row && (x == 1 || x == w - 1));
    const unsigned int bl = __ballot_sync(NYX_FULL, src);
    if (lane == 0) {
      bits[c] = bl;
      next[c] = carry;
    }
    if (bl) carry = 1 + 32 * c + __ffs(bl) - 1;
  }
  __syncwarp();
  carry = NYX_ERO_NEG;  // the last source before the chunk
  for (int c = 0; c < nc; ++c) {
    const int x0 = 1 + 32 * c;
    const int x = x0 + lane;
    const unsigned int bl = bits[c];
    const unsigned int lo = bl & (NYX_FULL >> (31 - lane));  // at or left
    const unsigned int hi = bl & (NYX_FULL << lane);         // at or right
    const int left = lo ? x0 + 31 - __clz(lo) : carry;
    const int right = hi ? x0 + __ffs(hi) - 1 : next[c];
    if (x >= 2 && x <= w - 2)
      gr[x] = static_cast<short>(min(min(x - left, right - x), NYX_ERO_FAR));
    if (bl) carry = x0 + 31 - __clz(bl);
  }
}

// Pass 2, columns: a block a ROI and 32 interior columns, thread (c, s)
// walking rows of segment s (one of 32 of ceil((h - 1) / 32) rows) of
// column c.  The column distance is d(y) = min over y' of g(y') + |y - y'|,
// two min-plus scans of slope 1 as two-level scans: each segment's minimum
// in shared memory, the earlier (or later) segments' minima as the carry.
// Walk 1 takes min(g - y) over the segment; walk 2 runs the forward scan
// F(y) = min(g(y), F(y - 1) + 1) = y + min over y' <= y of (g(y') - y'),
// writes F over g and takes min(F + y); walk 3 runs the backward scan
// d(y) = min(F(y), d(y + 1) + 1) and the max over the interior rows, which
// a warp reduces and one atomicMax a warp raises out[b] with, as the count
// min(max(T - 1, 0), CAP), monotone in T.
__global__ void __launch_bounds__(1024)
    erosion_cols_kernel(const int* __restrict__ heights,
                        const int* __restrict__ widths, short* __restrict__ g,
                        int* __restrict__ out, int H, int W) {
  __shared__ int seg_min[32][33];
  const int b = blockIdx.y;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  const int x = 2 + 32 * blockIdx.x + threadIdx.x;
  if (h < 4 || w < 4 || 2 + 32 * static_cast<int>(blockIdx.x) > w - 2)
    return;  // the whole block: no interior column here
  const bool on = x <= w - 2;
  const int s = threadIdx.y;
  const int R = (h - 1 + 31) / 32;  // rows 1 .. h-1
  const int ya = 1 + s * R;
  const int yb = min(ya + R, h);    // exclusive
  short* col = g + static_cast<size_t>(b) * H * W + x;
  int a = NYX_ERO_POS;
  if (on)
    for (int y = ya; y < yb; ++y)
      a = min(a, col[static_cast<size_t>(y) * W] - y);
  seg_min[s][threadIdx.x] = a;
  __syncthreads();
  int run = NYX_ERO_POS;
  for (int k = 0; k < s; ++k) run = min(run, seg_min[k][threadIdx.x]);
  int bmin = NYX_ERO_POS;
  if (on)
    for (int y = ya; y < yb; ++y) {
      short* p = col + static_cast<size_t>(y) * W;
      run = min(run, *p - y);
      const int F = y + run;
      *p = static_cast<short>(F);
      bmin = min(bmin, F + y);
    }
  __syncthreads();  // every walk 1 has read seg_min
  seg_min[s][threadIdx.x] = bmin;
  __syncthreads();
  run = NYX_ERO_POS;
  for (int k = s + 1; k < 32; ++k) run = min(run, seg_min[k][threadIdx.x]);
  int T = 0;
  if (on)
    for (int y = yb - 1; y >= ya; --y) {
      run = min(run, col[static_cast<size_t>(y) * W] + y);
      if (y >= 2 && y <= h - 2) T = max(T, run - y);
    }
  const int n = min(max(T - 1, 0), NYX_EROSION_CAP);
  const int wmax = __reduce_max_sync(NYX_FULL, n);
  if (threadIdx.x == 0 && wmax > 0) atomicMax(out + b, wmax);
}

template <typename U, int K>
static void ero_warp(int vec, int B, cudaStream_t st,
                     const unsigned char* mask, const int* hts,
                     const int* wds, int* out, int H, int W) {
  if (vec)
    erosion_warp_kernel<U, K, true><<<B, 32, 0, st>>>(mask, hts, wds, out, H,
                                                      W);
  else
    erosion_warp_kernel<U, K, false><<<B, 32, 0, st>>>(mask, hts, wds, out,
                                                       H, W);
}

template <typename U>
static int ero_warp_rows(int K, int vec, int B, cudaStream_t st,
                         const unsigned char* mask, const int* hts,
                         const int* wds, int* out, int H, int W) {
  switch (K) {
    case 1: ero_warp<U, 1>(vec, B, st, mask, hts, wds, out, H, W); break;
    case 2: ero_warp<U, 2>(vec, B, st, mask, hts, wds, out, H, W); break;
    case 4: ero_warp<U, 4>(vec, B, st, mask, hts, wds, out, H, W); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// path: 0 "warp", 1 "block", 2 "dist" (ops/binary.py erosion_plan): word
// bits 32 or 64 (warp), 16 (dist: the int16 plane); T threads a block (32
// on the warp path, the row pass's on the dist path); smem bytes of the
// block path's planes or of the row pass's chunk tables (T / 32 warps of
// 2 ceil(W / 32) ints); vec (W % 16 == 0 and the mask 16-byte aligned);
// scratch: the [B, H, W] int16 plane on the dist path, else NULL.
extern "C" int nyx_erosion(const void* mask, const void* heights,
                           const void* widths, void* scratch, void* out, int B,
                           int H, int W, int path, int bits, int T, int smem,
                           int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* mk = static_cast<const unsigned char*>(mask);
  const int* hts = static_cast<const int*>(heights);
  const int* wds = static_cast<const int*>(widths);
  int* o = static_cast<int*>(out);
  if (path == 0) {
    int K = 1;
    while (32 * K < H) K *= 2;
    if (W > 64 || H > 128 || (bits == 32 && W > 32) ||
        (bits != 32 && bits != 64) || T != 32)
      return static_cast<int>(cudaErrorInvalidValue);
    return bits == 32 ? ero_warp_rows<unsigned int>(K, vec, B, st, mk, hts,
                                                    wds, o, H, W)
                      : ero_warp_rows<unsigned long long>(K, vec, B, st, mk,
                                                          hts, wds, o, H, W);
  }
  if (path == 1) {
    const int NW = (W + 63) / 64;
    if (smem != 16 * H * NW || T > 1024 || T % 32 != 0 || T < NW)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = vec ? nyx_allow_smem(erosion_block_kernel<true>, smem)
                        : nyx_allow_smem(erosion_block_kernel<false>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (vec)
      erosion_block_kernel<true><<<B, T, smem, st>>>(mk, hts, wds, o, H, W,
                                                     NW);
    else
      erosion_block_kernel<false><<<B, T, smem, st>>>(mk, hts, wds, o, H, W,
                                                      NW);
    return static_cast<int>(cudaGetLastError());
  }
  const int NC = (W + 31) / 32;
  if (path != 2 || scratch == nullptr || bits != 16 || T > 1024 ||
      T % 32 != 0 || T < 32 || smem != (T / 32) * 8 * NC || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = nyx_allow_smem(erosion_rows_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  short* g = static_cast<short*>(scratch);
  const int warps = T / 32;
  const dim3 rows(max(1, (H - 1 + warps - 1) / warps), B);
  erosion_rows_kernel<<<rows, T, smem, st>>>(mk, hts, wds, g, o, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 cols(max(1, (W - 3 + 31) / 32), B);
  erosion_cols_kernel<<<cols, dim3(32, 32), 0, st>>>(hts, wds, g, o, H, W);
  return static_cast<int>(cudaGetLastError());
}
