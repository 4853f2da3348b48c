// K9 binary_quads: the Euler number's 2x2 quad counts and the fractal
// dimension's occupied-box counts of a batch of ROI masks.
//
// Replaces nyxus_tpu/ops/binary.py:70 euler_number (pad, a quad code per
// 2x2 window, one comparison and sum per pattern) and :93-102
// _box_count_at_scale as :105 fract_dim_boxcount calls it (a pad, reshape
// and any for every scale s = SB .. 2 and, where s <= 32, for each of four
// grid origins): dozens of small XLA ops a bucket become one launch.
//
//   quads[b] = (C1, C3, Cd) over the (H+1) x (W+1) windows of the 1-padded
//     mask, with q = 8*p[y,x] + 4*p[y,x+1] + 2*p[y+1,x] + p[y+1,x+1]:
//     C1 counts q in {8, 4, 2, 1}, C3 q in {7, 11, 13, 14}, Cd q in {9, 6}
//     (euler_number.h:42-58).
//   boxes[b, i, k] for scale s = SB >> i (i < S = log2 SB, SB the power of
//     two >= max(H, W)) and grid origin k = (ox, oy) = (0, 0), (s/2, 0),
//     (0, s/2), (s/2, s/2): the number of s x s boxes holding a mask pixel,
//     pixel (y, x) lying in box ((y + oy) / s, (x + ox) / s).  Origins
//     other than (0, 0) are counted only where s <= 32; above, all four
//     entries hold the (0, 0) count.
//
// Design: the mask is packed once into bit rows (bit x of row y's words is
// pixel (y, x)), read with 16-byte loads where a row is 16 or 32 bytes
// wide.  The quads of a row of windows are popcounts over four words: a and
// b the upper row shifted by one and not, c and d the lower row; C1 and C3
// are the odd-parity windows with fewer or more than two pixels set, Cd
// (a & d & ~b & ~c) | (b & c & ~a & ~d).  The boxes come from a pyramid:
// grid level t holds one bit a cell of t x t pixels (rows ceil(H / t),
// cells ceil(W / t)); a box of side s = 2t at any of the four origins is
// the union of two rows and two cells of level t, offset by one for the
// origin s/2, so each scale's four counts are popcounts of the pair ORs
// X = V | V >> 1 (V the OR of rows g and g + 1) under the even or odd
// cells, and level 2t is X's even bits compacted.  Three paths
// (binary.binary_quads_plan):
// - "warp": H, W <= 64; a warp a ROI, lane g holding grid row g in a
//   register (up to 32 x 32; beyond, rows 2g and 2g + 1 in 64-bit words
//   for the first level), row pairs by shuffles, counts by warp
//   reductions; no shared memory and no block barrier.
// - "block": a block a ROI, the bit rows in shared memory (level 1 in
//   words_a_row 32-bit words a row, the even levels in a second buffer),
//   a thread a word, one barrier a level.
// - "device": the same with the two buffers in a device scratch the
//   wrapper passes, where they do not fit a block's shared memory.
// Every count is a warp reduction; the block path adds its warps' sums in
// shared memory.  Each output is written once.  Bound on the card: the
// read of the mask (1 byte a pixel), and at the main buckets the launch
// and the load latency.
#include "common.cuh"

// bits 0, 2, ..., 30 of x moved to bits 0..15
__device__ __forceinline__ unsigned int nyx_even_bits(unsigned int x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0f0f0f0fu;
  x = (x | (x >> 4)) & 0x00ff00ffu;
  return (x | (x >> 8)) & 0x0000ffffu;
}

__device__ __forceinline__ int nyx_popc(unsigned int x) { return __popc(x); }
__device__ __forceinline__ int nyx_popc(unsigned long long x) {
  return __popcll(x);
}

// windows whose corners are the bits of a (upper left), b (upper right),
// c (lower left) and d (lower right)
template <typename U>
__device__ __forceinline__ void nyx_quads(U a, U b, U c, U d, int& c1,
                                          int& c3, int& cd) {
  const U odd = a ^ b ^ c ^ d;
  const U two = (a & b) | (c & d) | ((a | b) & (c | d));
  c1 += nyx_popc(odd & ~two);
  c3 += nyx_popc(odd & two);
  cd += nyx_popc((a & d & ~b & ~c) | (b & c & ~a & ~d));
}

#define NYX_EVEN 0x55555555u
#define NYX_ODD 0xaaaaaaaau
#define NYX_SMAX 31  // scales a launch may count (SB < 2^31)

// the box counts of levels lt0 .. S - 1 of a warp whose lane g holds grid
// row g of level 2^lt0 (at most 32 rows of at most 32 cells): boxes[i, k]
// for i = S - 1 - lt
__device__ __forceinline__ void nyx_warp_levels(unsigned int G, int lt0,
                                                int S, int* boxes, int lane) {
  for (int lt = lt0; lt < S; ++lt) {
    const int i = S - 1 - lt;
    unsigned int nb = __shfl_down_sync(NYX_FULL, G, 1);
    if (lane == 31) nb = 0;
    const unsigned int V = G | nb;
    const unsigned int X = V | (V >> 1);
    const int e = __popc(X & NYX_EVEN);
    const int o = __popc(X & NYX_ODD) + static_cast<int>(V & 1u);
    // even g: box rows at origin 0; odd g: at origin t, whose first box
    // row is grid row 0 alone (lane 0)
    int c00 = (lane & 1) ? 0 : e, c10 = (lane & 1) ? 0 : o;
    int c01 = (lane & 1) ? e : 0, c11 = (lane & 1) ? o : 0;
    if (lane == 0) {
      const unsigned int X0 = G | (G >> 1);
      c01 += __popc(X0 & NYX_EVEN);
      c11 += __popc(X0 & NYX_ODD) + static_cast<int>(G & 1u);
    }
    c00 = __reduce_add_sync(NYX_FULL, c00);
    c10 = __reduce_add_sync(NYX_FULL, c10);
    c01 = __reduce_add_sync(NYX_FULL, c01);
    c11 = __reduce_add_sync(NYX_FULL, c11);
    const bool four = (2 << lt) <= 32;
    if (lane < 4)
      boxes[i * 4 + lane] = (!four || lane == 0) ? c00
                            : lane == 1          ? c10
                            : lane == 2          ? c01
                                                 : c11;
    // level 2t: the even rows' X, even cells compacted
    const unsigned int up = __shfl_sync(NYX_FULL, nyx_even_bits(X),
                                        (2 * lane) & 31);
    G = lane < 16 ? up : 0u;
  }
}

// ---------------------------------------------------------------------------
// "warp": a warp a ROI of at most 32 x 32 pixels, lane y holding row y

__global__ void binary_quads_warp_kernel(const unsigned char* __restrict__ mask,
                                         int* __restrict__ quads,
                                         int* __restrict__ boxes, int B, int H,
                                         int W, int S, int vec) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const unsigned char* m = mask + static_cast<size_t>(b) * H * W;
  unsigned int R = 0;  // lane y: row y's pixels, bit x
  if (vec) {           // W is 16 or 32 and every row is 16-byte aligned
    if (lane < H) {
      const uint4* p = reinterpret_cast<const uint4*>(m + lane * W);
      R = nyx_pack16(__ldg(p));
      if (W == 32) R |= nyx_pack16(__ldg(p + 1)) << 16;
    }
  } else {
    for (int y = 0; y < H; ++y) {
      const unsigned int w =
          __ballot_sync(NYX_FULL, lane < W && m[y * W + lane] != 0);
      if (lane == y) R = w;
    }
  }
  // quads: lane y the windows over rows (y, y + 1), lane 0 also (-1, 0);
  // 64-bit words hold the W + 1 window columns
  int c1 = 0, c3 = 0, cd = 0;
  unsigned int below = __shfl_down_sync(NYX_FULL, R, 1);
  if (lane == 31) below = 0;
  const unsigned long long t64 = R, b64 = below;
  nyx_quads(t64 << 1, t64, b64 << 1, b64, c1, c3, cd);
  if (lane == 0) nyx_quads(0ull, 0ull, t64 << 1, t64, c1, c3, cd);
  c1 = __reduce_add_sync(NYX_FULL, c1);
  c3 = __reduce_add_sync(NYX_FULL, c3);
  cd = __reduce_add_sync(NYX_FULL, cd);
  if (lane < 3) quads[b * 3 + lane] = lane == 0 ? c1 : lane == 1 ? c3 : cd;
  nyx_warp_levels(R, 0, S, boxes + static_cast<size_t>(b) * S * 4, lane);
}

// ---------------------------------------------------------------------------
// "warp" up to 64 x 64: lane l holds rows 2l and 2l + 1 in 64-bit words;
// the first level's two grid rows a lane give level 2, a row a lane in
// 32-bit words, and the levels above are the 32 x 32 path's

__global__ void binary_quads_warp64_kernel(
    const unsigned char* __restrict__ mask, int* __restrict__ quads,
    int* __restrict__ boxes, int B, int H, int W, int S, int vec) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp leaves together
  const unsigned char* m = mask + static_cast<size_t>(b) * H * W;
  unsigned long long r[2] = {0ull, 0ull};  // rows 2 lane and 2 lane + 1
  if (vec) {  // W % 16 == 0 and every row 16-byte aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = 2 * lane + h;
      if (y < H) {
        const uint4* p = reinterpret_cast<const uint4*>(m + y * W);
        for (int q = 0; q < (W >> 4); ++q)
          r[h] |= static_cast<unsigned long long>(nyx_pack16(__ldg(p + q)))
                  << (16 * q);
      }
    }
  } else {
    for (int y = 0; y < H; ++y) {
      const unsigned char* row = m + y * W;
      const unsigned long long w =
          __ballot_sync(NYX_FULL, lane < W && row[lane] != 0) |
          (static_cast<unsigned long long>(__ballot_sync(
               NYX_FULL, lane + 32 < W && row[lane + 32] != 0))
           << 32);
      if ((y >> 1) == lane) r[y & 1] = w;
    }
  }
  unsigned long long nx = __shfl_down_sync(NYX_FULL, r[0], 1);
  if (lane == 31) nx = 0ull;
  // quads over rows (2l, 2l + 1), (2l + 1, 2l + 2) and, lane 0, (-1, 0);
  // window column 64 (W = 64) falls off the words: its upper left and
  // lower left corners are bit 63 of the rows, one of two set a C1
  int c1 = 0, c3 = 0, cd = 0;
  nyx_quads(r[0] << 1, r[0], r[1] << 1, r[1], c1, c3, cd);
  nyx_quads(r[1] << 1, r[1], nx << 1, nx, c1, c3, cd);
  c1 += static_cast<int>(((r[0] ^ r[1]) >> 63) + ((r[1] ^ nx) >> 63));
  if (lane == 0) {
    nyx_quads(0ull, 0ull, r[0] << 1, r[0], c1, c3, cd);
    c1 += static_cast<int>(r[0] >> 63);
  }
  c1 = __reduce_add_sync(NYX_FULL, c1);
  c3 = __reduce_add_sync(NYX_FULL, c3);
  cd = __reduce_add_sync(NYX_FULL, cd);
  if (lane < 3) quads[b * 3 + lane] = lane == 0 ? c1 : lane == 1 ? c3 : cd;
  // level 1 (s = 2): grid rows 2l (origin 0) and 2l + 1 (origin 1)
  const unsigned long long E = 0x5555555555555555ull, O = ~E;
  const unsigned long long V0 = r[0] | r[1], V1 = r[1] | nx;
  const unsigned long long X0 = V0 | (V0 >> 1), X1 = V1 | (V1 >> 1);
  int c00 = __popcll(X0 & E), c01 = __popcll(X1 & E);
  int c10 = __popcll(X0 & O) + static_cast<int>(V0 & 1);
  int c11 = __popcll(X1 & O) + static_cast<int>(V1 & 1);
  if (lane == 0) {
    const unsigned long long T = r[0] | (r[0] >> 1);
    c01 += __popcll(T & E);
    c11 += __popcll(T & O) + static_cast<int>(r[0] & 1);
  }
  int* out = boxes + static_cast<size_t>(b) * S * 4;
  c00 = __reduce_add_sync(NYX_FULL, c00);
  c10 = __reduce_add_sync(NYX_FULL, c10);
  c01 = __reduce_add_sync(NYX_FULL, c01);
  c11 = __reduce_add_sync(NYX_FULL, c11);
  if (lane < 4)
    out[(S - 1) * 4 + lane] = lane == 0 ? c00 : lane == 1 ? c10
                              : lane == 2 ? c01 : c11;
  const unsigned int G =
      nyx_even_bits(static_cast<unsigned int>(X0)) |
      (nyx_even_bits(static_cast<unsigned int>(X0 >> 32)) << 16);
  nyx_warp_levels(G, 1, S, out, lane);
}

// ---------------------------------------------------------------------------
// "block" / "device": a block a ROI, bit rows in shared or device memory

// V, the OR of grid rows g and g + 1, word k, at a level of GH rows of n
// words (0 past the rows' ends)
__device__ __forceinline__ unsigned int nyx_row_or(const unsigned int* G,
                                                   int GH, int n, int g,
                                                   int k) {
  if (k >= n) return 0u;
  unsigned int v = G[g * n + k];
  if (g + 1 < GH) v |= G[(g + 1) * n + k];
  return v;
}

// X = V | V >> 1, word k: bit c the OR of cells c and c + 1 of both rows
__device__ __forceinline__ unsigned int nyx_pair_or(const unsigned int* G,
                                                    int GH, int n, int g,
                                                    int k) {
  const unsigned int v = nyx_row_or(G, GH, n, g, k);
  return v | (v >> 1) | (nyx_row_or(G, GH, n, g, k + 1) << 31);
}

__device__ __forceinline__ void nyx_block_add(int* cnt, int v, int lane) {
  v = __reduce_add_sync(NYX_FULL, v);
  if (lane == 0 && v) atomicAdd(cnt, v);
}

__global__ void binary_quads_block_kernel(
    const unsigned char* __restrict__ mask, int* __restrict__ quads,
    int* __restrict__ boxes, unsigned int* scratch, long long scratch_words,
    int H, int W, int S, int vec) {
  extern __shared__ __align__(16) unsigned int nyx_bits[];
  __shared__ int cnt[3 + 4 * NYX_SMAX];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = bd >> 5;
  const int NW = (W + 31) >> 5;
  unsigned int* A = scratch ? scratch + b * scratch_words : nyx_bits;
  unsigned int* Bf = A + H * NW;
  for (int k = tid; k < 3 + 4 * S; k += bd) cnt[k] = 0;
  const unsigned char* m = mask + static_cast<size_t>(b) * H * W;
  if (vec) {  // W % 32 == 0 and the mask 16-byte aligned: a word a thread
#pragma unroll 4
    for (int j = tid; j < H * NW; j += bd) {
      const uint4* p = reinterpret_cast<const uint4*>(m) + 2 * j;
      A[j] = nyx_pack16(__ldg(p)) | (nyx_pack16(__ldg(p + 1)) << 16);
    }
  } else {  // a word a warp, one coalesced byte a lane
    for (int j = warp; j < H * NW; j += nwarps) {
      const int y = j / NW, x = ((j - y * NW) << 5) + lane;
      const unsigned int w =
          __ballot_sync(NYX_FULL, x < W && m[static_cast<size_t>(y) * W + x]);
      if (lane == 0) A[j] = w;
    }
  }
  __syncthreads();
  // quads: window row y over mask rows (y - 1, y), NW + 1 words a row for
  // the W + 1 window columns
  {
    int c1 = 0, c3 = 0, cd = 0;
    const int n1 = NW + 1;
    for (int j = tid; j < (H + 1) * n1; j += bd) {
      const int y = j / n1, k = j - y * n1;
      unsigned int t = 0, tl = 0, u = 0, ul = 0;  // words k and k - 1
      if (y > 0) {
        if (k < NW) t = A[(y - 1) * NW + k];
        if (k > 0) tl = A[(y - 1) * NW + k - 1];
      }
      if (y < H) {
        if (k < NW) u = A[y * NW + k];
        if (k > 0) ul = A[y * NW + k - 1];
      }
      nyx_quads((t << 1) | (tl >> 31), t, (u << 1) | (ul >> 31), u, c1, c3,
                cd);
    }
    nyx_block_add(&cnt[0], c1, lane);
    nyx_block_add(&cnt[1], c3, lane);
    nyx_block_add(&cnt[2], cd, lane);
  }
  // boxes: level t in G (GH rows of n words, cells ceil(W / t)), level 2t
  // built into N
  unsigned int* G = A;
  unsigned int* N = Bf;
  int GH = H, GW = W, n = NW;
  for (int lt = 0; lt < S; ++lt) {
    const int i = S - 1 - lt;
    int c00 = 0, c10 = 0, c01 = 0, c11 = 0;
    for (int j = tid; j < GH * n; j += bd) {
      const int g = j / n, k = j - g * n;
      const unsigned int V = nyx_row_or(G, GH, n, g, k);
      const unsigned int X =
          V | (V >> 1) | (nyx_row_or(G, GH, n, g, k + 1) << 31);
      const int e = __popc(X & NYX_EVEN);
      const int o = __popc(X & NYX_ODD) + (k == 0 ? static_cast<int>(V & 1u)
                                                  : 0);
      if (g & 1) {
        c01 += e;
        c11 += o;
      } else {
        c00 += e;
        c10 += o;
      }
      if (g == 0) {  // the first box row at origin t: grid row 0 alone
        const unsigned int G0 = G[k];
        const unsigned int X0 =
            G0 | (G0 >> 1) | ((k + 1 < n ? G[k + 1] : 0u) << 31);
        c01 += __popc(X0 & NYX_EVEN);
        c11 += __popc(X0 & NYX_ODD) + (k == 0 ? static_cast<int>(G0 & 1u)
                                              : 0);
      }
    }
    const int GH2 = (GH + 1) >> 1, GW2 = (GW + 1) >> 1, n2 = (GW2 + 31) >> 5;
    if (lt + 1 < S) {
      for (int j = tid; j < GH2 * n2; j += bd) {
        const int g2 = j / n2, k2 = j - g2 * n2;
        N[j] = nyx_even_bits(nyx_pair_or(G, GH, n, 2 * g2, 2 * k2)) |
               (nyx_even_bits(nyx_pair_or(G, GH, n, 2 * g2, 2 * k2 + 1))
                << 16);
      }
    }
    nyx_block_add(&cnt[3 + 4 * i], c00, lane);
    nyx_block_add(&cnt[4 + 4 * i], c10, lane);
    nyx_block_add(&cnt[5 + 4 * i], c01, lane);
    nyx_block_add(&cnt[6 + 4 * i], c11, lane);
    __syncthreads();
    unsigned int* tmp = G;
    G = N;
    N = tmp;
    GH = GH2;
    GW = GW2;
    n = n2;
  }
  __syncthreads();
  if (tid < 3) quads[b * 3 + tid] = cnt[tid];
  for (int k = tid; k < 4 * S; k += bd) {
    const int i = k >> 2;  // s = 2^(S - i)
    boxes[static_cast<size_t>(b) * S * 4 + k] =
        cnt[3 + (S - i <= 5 ? k : 4 * i)];
  }
}

// quads: int32 [B, 3]; boxes: int32 [B, S, 4] (S may be 0), SB = 2^S >=
// max(H, W).  path 0 "warp" (rois a block of one warp each; words 1:
// H, W <= 32, a row a lane; words 2: H, W <= 64, two rows a lane in 64-bit
// words), 1 "block" (the bit rows in ``smem`` bytes of shared memory),
// 2 "device" (in
// ``scratch``, scratch_words 32-bit words a ROI).  vec: 16-byte loads
// (warp: W % 16 == 0; block: W % 32 == 0), the mask 16-byte aligned.
extern "C" int nyx_binary_quads(const void* mask, void* quads, void* boxes,
                                void* scratch, long long scratch_words, int B,
                                int H, int W, int S, int path, int rois,
                                int words, int smem, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  if (path == 0) {
    const dim3 grid((B + rois - 1) / rois), block(32 * rois);
    if (words == 1)
      binary_quads_warp_kernel<<<grid, block, 0, st>>>(
          m, static_cast<int*>(quads), static_cast<int*>(boxes), B, H, W, S,
          vec);
    else
      binary_quads_warp64_kernel<<<grid, block, 0, st>>>(
          m, static_cast<int*>(quads), static_cast<int*>(boxes), B, H, W, S,
          vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (S > NYX_SMAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = path == 1 ? static_cast<size_t>(smem) : 0;
  cudaError_t e = nyx_allow_smem(binary_quads_block_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long items = static_cast<long long>(H) * ((W + 31) >> 5);
  int threads = 64;
  while (threads < 512 && threads < items) threads *= 2;
  binary_quads_block_kernel<<<B, threads, bytes, st>>>(
      m, static_cast<int*>(quads), static_cast<int*>(boxes),
      path == 2 ? static_cast<unsigned int*>(scratch) : nullptr,
      scratch_words, H, W, S, vec);
  return static_cast<int>(cudaGetLastError());
}
