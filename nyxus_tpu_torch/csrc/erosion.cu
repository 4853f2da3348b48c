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
// Design: the mask is packed into bit rows (bit x of a row's word is pixel
// x, 16 bytes at a time where rows are 16-byte multiples), and a step on a
// row's word is
//   next = cur & (up & down & (cur << 1) & (cur >> 1) | ~interior)
// with ``interior`` the word's columns 2..w-2 on rows 2..h-2 and zero on
// the other rows; the interior is alive while any next & interior is set.
// A step that changes nothing leaves the interior as it is for good, so
// the count is then the cap (a full AABB, whose frozen border feeds the
// interior, stops there at once).  Three paths (ops/binary.py
// erosion_plan):
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
// - "device": the first port's kernel, two byte planes in a device scratch
//   (buckets whose bit planes pass a block's shared memory, past 968 x
//   968).
// Bound on the card: the dependent steps (about the ROI's inradius of
// them); the bytes bound is the mask read once.
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
// "device": a block a ROI, two byte planes in a device scratch

__global__ void erosion_device_kernel(const unsigned char* __restrict__ mask,
                                      const int* __restrict__ heights,
                                      const int* __restrict__ widths,
                                      unsigned char* scratch,
                                      int* __restrict__ out, int H, int W) {
  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  unsigned char* cur = scratch + 2 * plane * b;
  unsigned char* nxt = cur + plane;
  const int h = min(heights[b], H);
  const int w = min(widths[b], W);
  const unsigned char* mb = mask + plane * b;
  for (int p = threadIdx.x; p < h * w; p += blockDim.x) {
    const unsigned char v = mb[(p / w) * W + p % w] ? 1 : 0;
    cur[p] = v;
    nxt[p] = v;  // the frozen border must read the same in both planes
  }
  __syncthreads();
  const int iw = w - 3;  // interior columns 2 .. w-2
  const int ih = h - 3;
  const int ni = (iw > 0 && ih > 0) ? iw * ih : 0;
  int n = 0;
  while (true) {
    int alive = 0;
    for (int k = threadIdx.x; k < ni; k += blockDim.x) {
      const int y = 2 + k / iw;
      const int x = 2 + k % iw;
      const int p = y * w + x;
      const unsigned char v = cur[p] & cur[p - w] & cur[p + w] & cur[p - 1] &
                              cur[p + 1];
      nxt[p] = v;
      alive |= v;
    }
    // every write of this step is done, and no thread reads ``cur`` again
    // before the next step overwrites it
    if (!__syncthreads_or(alive)) break;
    if (++n >= NYX_EROSION_CAP) break;
    unsigned char* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (threadIdx.x == 0) out[b] = n;
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

// path: 0 "warp", 1 "block", 2 "device" (ops/binary.py erosion_plan): word
// bits 32 or 64 (warp), T threads a block (32 on the warp path), smem bytes
// of the block path's planes, vec (W % 16 == 0 and the mask 16-byte
// aligned); scratch: [B, 2, H, W] bytes on the device path, else NULL.
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
  if (path != 2 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  erosion_device_kernel<<<B, NYX_BLOCK, 0, st>>>(
      mk, hts, wds, static_cast<unsigned char*>(scratch), o, H, W);
  return static_cast<int>(cudaGetLastError());
}
