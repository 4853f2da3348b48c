// K3 glrlm_runs: maximal same-level runs along 0, 45, 90 and 135 degrees,
// counted into a (level, run length) matrix per angle.
//
// Replaces nyxus_tpu/ops/glrlm.py:41 _runs_matrix_along_x, :64 _shear and
// :85 run_matrices (a reverse cumulative min over "level changes here" flags
// plus a one-hot matmul on the TPU, with the diagonals sheared into columns
// by a padded copy).  The scan lines are those _shear produces:
//   0 deg   rows, step (dx, dy) = (+1, 0)
//   45 deg  lines of constant x - y, step (+1, +1)
//   90 deg  columns, step (0, +1)
//   135 deg lines of constant x + y, step (-1, +1)
// A run is a maximal stretch of ``valid`` pixels with equal level; it is
// counted at (level - 1, min(length, nr) - 1), levels outside 1..ng dropped.
//
// Design: one block per (ROI, angle).  The block stages its crop once in
// shared memory as codes (0 off ``valid``, the level for 1..ng, one
// sentinel ng + 1 for every other valid level: such runs are dropped
// whatever their level and still end their neighbours', so folding them is
// exact), 16 bits a pixel while ng < 65535, with 16-byte loads of the
// levels, and zeroes its counts.  Then a warp takes a scan line (two a
// step, their loads in flight together, where no line is longer than 32),
// 32 pixels a step from the line's end back to its start, a lane a pixel: a
// ballot of "the next pixel continues my run" gives each run start (a
// valid pixel whose predecessor is off the line, not valid or of another
// code) its end as the first clear bit at or above its lane, or, for a run
// that reaches the word's top, the first clear bit of the words above
// (carried down the line).  One shared-memory atomic a run.  The counts
// (glrlm.glrlm_runs_plan):
// - "smem32": 32-bit counts in shared memory;
// - "smem16": two 16-bit counts a word, where 4 * ng * nr does not fit and
//   H * W <= 65535, so that no count passes 65535;
// - "device": 32-bit counts in an int32 [B, 4, ng, nr] device buffer the
//   wrapper passes, zeroed by the block that owns its slice.
// The crop is read from device memory instead of staged where it does not
// fit beside the counts.  The write-out reads the counts once, in float4 /
// double2 stores where the matrix allows.  Bound on the card: at the main
// buckets the launch, the staging latency and the block's line steps; the
// bytes (the crop in, the [ng, nr] matrix out) are far below.
#include "common.cuh"

#define NYX_RUNS_SMEM32 0
#define NYX_RUNS_SMEM16 1
#define NYX_RUNS_DEVICE 2

// a pixel's code: 0 off valid, its level in 1..ng, else the sentinel ng + 1
__device__ __forceinline__ unsigned int nyx_code(int l, bool v, int ng) {
  if (!v) return 0u;
  return (l >= 1 && l <= ng) ? static_cast<unsigned int>(l)
                             : static_cast<unsigned int>(ng) + 1u;
}

template <typename CT>
struct NyxRunCrop {
  const CT* codes;  // staged, row stride ws; NULL to read lev / valid
  const int* lev;
  const unsigned char* valid;
  int W, ws, ng;

  __device__ __forceinline__ unsigned int at(int y, int x) const {
    if (codes) return codes[y * ws + x];
    const int p = y * W + x;
    return nyx_code(__ldg(lev + p), __ldg(valid + p) != 0, ng);
  }
};

// a scan line: its first pixel, its step and its length
struct NyxLine {
  int x0, y0, sx, sy, len;
};

__device__ __forceinline__ NyxLine nyx_line(int a, int line, int H, int W) {
  if (a == 0) return NyxLine{0, line, 1, 0, W};
  if (a == 2) return NyxLine{line, 0, 0, 1, H};
  if (a == 1) {
    const int d = line - (H - 1);  // x - y
    const int x0 = d > 0 ? d : 0, y0 = d < 0 ? -d : 0;
    return NyxLine{x0, y0, 1, 1, min(W - x0, H - y0)};
  }
  const int y0 = line - (W - 1) > 0 ? line - (W - 1) : 0;  // x + y = line
  const int x0 = line - y0;
  return NyxLine{x0, y0, -1, 1, min(x0 + 1, H - y0)};
}

// the codes at position pos of the line and at its two neighbours (0 off
// the line)
template <typename CT>
__device__ __forceinline__ void nyx_load3(const NyxRunCrop<CT>& crop,
                                          const NyxLine& l, int pos,
                                          unsigned int& cur,
                                          unsigned int& prev,
                                          unsigned int& next) {
  cur = prev = next = 0u;
  if (pos < l.len) {
    const int y = l.y0 + pos * l.sy, x = l.x0 + pos * l.sx;
    cur = crop.at(y, x);
    if (pos > 0) prev = crop.at(y - l.sy, x - l.sx);
    if (pos + 1 < l.len) next = crop.at(y + l.sy, x + l.sx);
  }
}

// word k of a line, a lane a pixel: each run start counts its run, whose
// end is the first clear "continues" bit at or above its lane, else
// ``stop``, the first clear bit of the words above; stop then moves to
// this word's first clear bit
__device__ __forceinline__ void nyx_runs_word(
    unsigned int* cnt, int mode, int nr, unsigned int sentinel,
    unsigned int cur, unsigned int prev, unsigned int next, int k, int lane,
    int& stop) {
  const unsigned int ends =
      ~__ballot_sync(NYX_FULL, cur != 0u && next == cur);
  if (cur != 0u && prev != cur && cur != sentinel) {
    const unsigned int z = ends & (0xffffffffu << lane);
    const int end = z ? (k << 5) + __ffs(z) - 1 : stop;
    const int run = end - ((k << 5) + lane) + 1;
    const int cell =
        static_cast<int>(cur - 1u) * nr + (run < nr ? run : nr) - 1;
    if (mode == NYX_RUNS_SMEM16)
      atomicAdd(cnt + (cell >> 1), 1u << ((cell & 1) << 4));
    else
      atomicAdd(cnt + cell, 1u);
  }
  if (ends) stop = (k << 5) + __ffs(ends) - 1;
}

// counts 4k .. 4k + 3
__device__ __forceinline__ uint4 nyx_counts4(const unsigned int* cnt,
                                             int mode, int k) {
  if (mode == NYX_RUNS_SMEM32) return reinterpret_cast<const uint4*>(cnt)[k];
  if (mode == NYX_RUNS_SMEM16) {
    const uint2 w = reinterpret_cast<const uint2*>(cnt)[k];
    return make_uint4(w.x & 0xffffu, w.x >> 16, w.y & 0xffffu, w.y >> 16);
  }
  return __ldcg(reinterpret_cast<const uint4*>(cnt) + k);
}

__device__ __forceinline__ unsigned int nyx_count(const unsigned int* cnt,
                                                  int mode, int k) {
  if (mode == NYX_RUNS_SMEM32) return cnt[k];
  if (mode == NYX_RUNS_SMEM16) return (cnt[k >> 1] >> ((k & 1) << 4)) & 0xffffu;
  return __ldcg(cnt + k);
}

template <typename T>
__device__ __forceinline__ void nyx_store_counts4(T* o, int k, uint4 c);

template <>
__device__ __forceinline__ void nyx_store_counts4<float>(float* o, int k,
                                                         uint4 c) {
  reinterpret_cast<float4*>(o)[k] = make_float4(
      static_cast<float>(c.x), static_cast<float>(c.y),
      static_cast<float>(c.z), static_cast<float>(c.w));
}

template <>
__device__ __forceinline__ void nyx_store_counts4<double>(double* o, int k,
                                                          uint4 c) {
  double2* p = reinterpret_cast<double2*>(o) + 2 * k;
  p[0] = make_double2(static_cast<double>(c.x), static_cast<double>(c.y));
  p[1] = make_double2(static_cast<double>(c.z), static_cast<double>(c.w));
}

// mode: NYX_RUNS_*; staged: the crop in shared memory after cnt_bytes of
// counts, row stride ws codes; vec: W % 4 == 0 and lev / valid 16- / 4-byte
// aligned; vec_out: ng * nr % 4 == 0 and out 16-byte aligned
template <typename CT, typename T>
__global__ void __launch_bounds__(1024) glrlm_runs_kernel(
    const int* __restrict__ lev, const unsigned char* __restrict__ valid,
    T* __restrict__ out, unsigned int* __restrict__ gcnt, int H, int W,
    int ng, int nr, int mode, int staged, int ws, int cnt_bytes, int vec,
    int vec_out) {
  extern __shared__ __align__(16) unsigned char nyx_runs_smem[];
  const int b = blockIdx.x;
  const int a = blockIdx.y;  // 0: 0 deg, 1: 45 deg, 2: 90 deg, 3: 135 deg
  const int tid = threadIdx.x, bd = blockDim.x;
  const int nm = ng * nr;
  const size_t base = static_cast<size_t>(b) * H * W;
  const int* lb = lev + base;
  const unsigned char* vb = valid + base;
  unsigned int* cnt =
      mode == NYX_RUNS_DEVICE ? gcnt + (static_cast<size_t>(b) * 4 + a) * nm
                              : reinterpret_cast<unsigned int*>(nyx_runs_smem);
  CT* codes = staged ? reinterpret_cast<CT*>(nyx_runs_smem + cnt_bytes)
                     : nullptr;
  // stage the crop as codes, and zero the counts
  if (staged) {
    if (vec) {
      const int4* l4 = reinterpret_cast<const int4*>(lb);
      const unsigned int* v4 = reinterpret_cast<const unsigned int*>(vb);
#pragma unroll 4
      for (int j = tid; j < (H * W) >> 2; j += bd) {
        const int4 l = __ldg(l4 + j);
        const unsigned int v = __ldg(v4 + j);
        const int y = (4 * j) / W, x = 4 * j - y * W;
        CT* c = codes + y * ws + x;
        c[0] = static_cast<CT>(nyx_code(l.x, v & 0xffu, ng));
        c[1] = static_cast<CT>(nyx_code(l.y, (v >> 8) & 0xffu, ng));
        c[2] = static_cast<CT>(nyx_code(l.z, (v >> 16) & 0xffu, ng));
        c[3] = static_cast<CT>(nyx_code(l.w, v >> 24, ng));
      }
    } else {
#pragma unroll 4
      for (int p = tid; p < H * W; p += bd) {
        const int y = p / W, x = p - y * W;
        codes[y * ws + x] =
            static_cast<CT>(nyx_code(__ldg(lb + p), __ldg(vb + p) != 0, ng));
      }
    }
  }
  {
    const int nz = mode == NYX_RUNS_SMEM16 ? (nm + 1) >> 1 : nm;
    if (mode == NYX_RUNS_DEVICE) {
      for (int k = tid; k < nz; k += bd) cnt[k] = 0u;
    } else {
      uint4* c4 = reinterpret_cast<uint4*>(cnt);
      for (int k = tid; k < (nz >> 2); k += bd) c4[k] = make_uint4(0, 0, 0, 0);
      for (int k = (nz & ~3) + tid; k < nz; k += bd) cnt[k] = 0u;
    }
  }
  __syncthreads();

  const NyxRunCrop<CT> crop{codes, lb, vb, W, ws, ng};
  const unsigned int sentinel = static_cast<unsigned int>(ng) + 1u;
  const int lane = tid & 31, warp = tid >> 5, nwarps = bd >> 5;
  const int nlines = (a == 0) ? H : (a == 2) ? W : H + W - 1;
  const int longest = (a == 0) ? W : (a == 2) ? H : min(H, W);
  if (longest <= 32) {
    // lines of one word: a warp takes two a step, both lines' loads in
    // flight before either's ballot
    for (int line = warp; line < nlines; line += 2 * nwarps) {
      const NyxLine l1 = nyx_line(a, line, H, W);
      const NyxLine l2 = line + nwarps < nlines
                             ? nyx_line(a, line + nwarps, H, W)
                             : NyxLine{0, 0, 0, 0, 0};
      unsigned int c1, p1, n1, c2, p2, n2;
      nyx_load3(crop, l1, lane, c1, p1, n1);
      nyx_load3(crop, l2, lane, c2, p2, n2);
      int stop1 = l1.len - 1, stop2 = l2.len - 1;
      nyx_runs_word(cnt, mode, nr, sentinel, c1, p1, n1, 0, lane, stop1);
      nyx_runs_word(cnt, mode, nr, sentinel, c2, p2, n2, 0, lane, stop2);
    }
  } else {
    for (int line = warp; line < nlines; line += nwarps) {
      const NyxLine l = nyx_line(a, line, H, W);
      int stop = l.len - 1;  // first clear "continues" bit above the word
      for (int k = (l.len - 1) >> 5; k >= 0; --k) {
        unsigned int cur, prev, next;
        nyx_load3(crop, l, (k << 5) + lane, cur, prev, next);
        nyx_runs_word(cnt, mode, nr, sentinel, cur, prev, next, k, lane,
                      stop);
      }
    }
  }
  __syncthreads();

  T* o = out + (static_cast<size_t>(b) * 4 + a) * nm;
  if (vec_out) {
#pragma unroll 4
    for (int k = tid; k < (nm >> 2); k += bd)
      nyx_store_counts4<T>(o, k, nyx_counts4(cnt, mode, k));
  } else {
#pragma unroll 4
    for (int k = tid; k < nm; k += bd)
      o[k] = static_cast<T>(nyx_count(cnt, mode, k));
  }
}

template <typename CT, typename T>
static int launch(const void* lev, const void* valid, void* out, void* gcnt,
                  int B, int H, int W, int ng, int nr, int mode, int staged,
                  int ws, int cnt_bytes, int smem, int threads, int vec,
                  int vec_out, cudaStream_t stream) {
  cudaError_t e = nyx_allow_smem(glrlm_runs_kernel<CT, T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  glrlm_runs_kernel<CT, T><<<dim3(B, 4), threads, smem, stream>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(valid),
      static_cast<T*>(out), static_cast<unsigned int*>(gcnt), H, W, ng, nr,
      mode, staged, ws, cnt_bytes, vec, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// out: [B, 4, ng, nr] float32 / float64.  mode and the layout are
// glrlm_runs_plan's: code_bits 16 or 32 for a staged crop (row stride ws
// codes, after cnt_bytes of counts; smem bytes in all), 0 to read the crop
// from device memory; gcnt an int32 [B, 4, ng, nr] for mode 2, else NULL.
extern "C" int nyx_glrlm_runs(const void* lev, const void* valid, void* out,
                              void* gcnt, int B, int H, int W, int ng, int nr,
                              int mode, int code_bits, int ws, int cnt_bytes,
                              int smem, int threads, int vec, int vec_out,
                              int is_f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int staged = code_bits != 0;
  if (code_bits == 32)
    return is_f64 ? launch<unsigned int, double>(
                        lev, valid, out, gcnt, B, H, W, ng, nr, mode, staged,
                        ws, cnt_bytes, smem, threads, vec, vec_out, st)
                  : launch<unsigned int, float>(
                        lev, valid, out, gcnt, B, H, W, ng, nr, mode, staged,
                        ws, cnt_bytes, smem, threads, vec, vec_out, st);
  return is_f64 ? launch<unsigned short, double>(
                      lev, valid, out, gcnt, B, H, W, ng, nr, mode, staged,
                      ws, cnt_bytes, smem, threads, vec, vec_out, st)
                : launch<unsigned short, float>(
                      lev, valid, out, gcnt, B, H, W, ng, nr, mode, staged,
                      ws, cnt_bytes, smem, threads, vec, vec_out, st);
}
