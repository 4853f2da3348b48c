// K16 stencil3d: per-voxel neighbour statistics of the 3D dependence and
// neighbourhood families, over a shift table or a Chebyshev window.
//
// Replaces the shifted3d loops of nyxus_tpu/ops/texture3d.py:350
// gldm3d_all (26 shifts), :402 ngldm3d_all (the reference's 24 NGLDM
// shifts) and :369 ngtdm3d_all (the (2r+1)^3 - 1 offsets of the Chebyshev
// window), each a padded copy of the cube per shift on the TPU.  Neighbours
// outside the cube, or not marked in ``part``, do not take part.  Two
// modes:
//   table   same[v] = number of shifts s with part[v + s] and
//           lev[v + s] == lev[v]   (GLDM: N26, part = the AABB; NGLDM:
//           N24, part = the AABB)
//   window  nsum[v] = sum of lev[v + s] and ncnt[v] = number of s over the
//           marked neighbours in the window of radius r (NGTDM: lev =
//           where(aabb, level, 0), part = the AABB, background included)
// The histograms then go through K1.  Integer outputs (window sums in
// 32-bit two's complement, as the plain version's int32 adds), so the
// kernel equals its plain version bit for bit for every int32 level.
//
// Bound on the card: memory traffic, 5 bytes read and 4 (table) or 8
// (window) written a voxel.
//
// Two designs, chosen by the wrapper's plan (ops/texture3d.py
// stencil3d_plan):
//
// The slab path, one launch: a block for each (ROI, slab of Zt planes, tile
// of Yt rows), so that a bucket of a few ROIs still fills the card.  The
// block stages its tile with a halo of r planes and rows on each side (r = 1
// for a table of unit shifts, the radius for a window) into shared memory
// once: the int32 levels and the part bytes side by side, each row padded
// with zeros so that its interior starts at a 16-byte boundary, copied with
// 16-byte cp.async row chunks (4-byte, or bytes, where a row is not
// 16-byte aligned); planes, rows and columns beyond the cube stay zero, so
// no bounds test is left.  A thread owns a column (y, x) of the tile and
// walks its Zt planes along z, which keeps a warp on consecutive words
// (no bank conflicts, one coalesced write an output and plane): in table
// mode it holds the 3 x 3 x 3 neighbourhood in registers (27 levels, the
// part bits in one word) and loads one 3 x 3 patch a plane; the count is a
// popcount of the equal-level bits, the part bits and the table's mask (a
// bit a shift; the N26 and N24 masks compiled in).  In window mode it keeps
// the last 2r + 1 plane sums (the (2r+1)^2 masked levels and part bits of
// the patch) and the window is their sum minus the centre.  Index
// arithmetic is 32-bit.
//
// The voxel path (tables with a shift beyond one voxel or a repeated shift,
// windows of radius 0 or above 2, and shapes where the plan finds a staged
// tile too costly): one thread per voxel over the flattened [B, D, H, W]
// batch; the shift table is a kernel argument (26 x 3 ints at most), the
// neighbours' reads are served by L1/L2.
#include <cstdint>

#include "common.cuh"

struct NyxShifts {
  int n;
  int dz[26];
  int dy[26];
  int dx[26];
};

__global__ void stencil3d_table_kernel(const int* __restrict__ lev,
                                       const unsigned char* __restrict__ part,
                                       int* __restrict__ same, long long total,
                                       int D, int H, int W, NyxShifts sh) {
  const int HW = H * W;
  const int A = D * HW;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    const int* lb = lev + b * A;
    const unsigned char* pb = part + b * A;
    const int l = lb[p];
    int s = 0;
    for (int k = 0; k < sh.n; ++k) {
      const int nz = z + sh.dz[k], ny = y + sh.dy[k], nx = x + sh.dx[k];
      if (nz < 0 || nz >= D || ny < 0 || ny >= H || nx < 0 || nx >= W)
        continue;
      const int q = nz * HW + ny * W + nx;
      s += (pb[q] && lb[q] == l);
    }
    same[t] = s;
  }
}

__global__ void stencil3d_window_kernel(const int* __restrict__ lev,
                                        const unsigned char* __restrict__ part,
                                        int* __restrict__ nsum,
                                        int* __restrict__ ncnt, long long total,
                                        int D, int H, int W, int rad) {
  const int HW = H * W;
  const int A = D * HW;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long b = t / A;
    const int p = static_cast<int>(t - b * A);
    const int z = p / HW;
    const int r = p - z * HW;
    const int y = r / W;
    const int x = r - y * W;
    const int* lb = lev + b * A;
    const unsigned char* pb = part + b * A;
    unsigned int s = 0;
    int c = 0;
    for (int nz = max(z - rad, 0); nz <= min(z + rad, D - 1); ++nz) {
      for (int ny = max(y - rad, 0); ny <= min(y + rad, H - 1); ++ny) {
        for (int nx = max(x - rad, 0); nx <= min(x + rad, W - 1); ++nx) {
          if (nz == z && ny == y && nx == x) continue;
          const int q = nz * HW + ny * W + nx;
          if (pb[q]) {
            s += static_cast<unsigned int>(lb[q]);
            ++c;
          }
        }
      }
    }
    nsum[t] = static_cast<int>(s);
    ncnt[t] = c;
  }
}

// ---------------------------------------------------------------------------
// slab path

// zero columns on each side of a staged row: 4 int32 levels, 16 part bytes
#define NYX_ST3_XL 4
#define NYX_ST3_XB 16
#define NYX_ST3_THREADS_MAX 512
// a table as a mask over the 3^3 neighbourhood: bit (dz + 1) * 9 +
// (dy + 1) * 3 + dx + 1 for the shift (dz, dy, dx)
#define NYX_ST3_N26 (0x7ffffffu & ~(1u << 13))
#define NYX_ST3_N24 (NYX_ST3_N26 & ~((1u << 4) | (1u << 22)))

struct NyxSlab {
  int D, H, W;  // the cube
  int Zt, Yt;   // a block's planes and rows
  int nz, ny;   // slabs and row tiles a ROI
  int PL, PB;   // staged row pitches: int32 levels, part bytes
  int rows;     // staged rows a plane, Yt + 2r
};

// the tile (z0, y0) of ROI b with R planes and rows of halo: zeroed, then
// the rows inside the cube copied
template <int R>
__device__ void st3_stage(const int* __restrict__ lb,
                          const unsigned char* __restrict__ pb, int* ls,
                          unsigned char* ps, const NyxSlab& g, int z0,
                          int y0) {
  const int planes = g.Zt + 2 * R;
  const int words = planes * g.rows * (4 * g.PL + g.PB) / 16;
  uint4* s4 = reinterpret_cast<uint4*>(ls);
  for (int k = threadIdx.x; k < words; k += blockDim.x)
    s4[k] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int za = max(z0 - R, 0), zb = min(z0 + g.Zt + R, g.D);
  const int ya = max(y0 - R, 0), yb = min(y0 + g.Yt + R, g.H);
  const int nyr = yb - ya;
  const int nrows = (zb - za) * nyr;
  const int W = g.W;
  // chunks of cw elements a row: (staged row, global row) of chunk row k
#define NYX_ST3_ROW(k)                                                     \
  const int zz = za + (k) / nyr;                                           \
  const int yy = ya + (k) - ((k) / nyr) * nyr;                             \
  const int srow = (zz - z0 + R) * g.rows + (yy - y0 + R);                 \
  const int grow = zz * g.H + yy;
  if ((W & 3) == 0 && (reinterpret_cast<uintptr_t>(lb) & 15) == 0) {
    const int cpr = W >> 2;
    for (int k = threadIdx.x; k < nrows * cpr; k += blockDim.x) {
      const int row = k / cpr;
      const int c = (k - row * cpr) << 2;
      NYX_ST3_ROW(row)
      nyx_cp16(ls + srow * g.PL + NYX_ST3_XL + c, lb + grow * W + c);
    }
  } else {
    for (int k = threadIdx.x; k < nrows * W; k += blockDim.x) {
      const int row = k / W;
      const int c = k - row * W;
      NYX_ST3_ROW(row)
      nyx_cp4(ls + srow * g.PL + NYX_ST3_XL + c, lb + grow * W + c);
    }
  }
  const uintptr_t pa = reinterpret_cast<uintptr_t>(pb);
  if ((W & 15) == 0 && (pa & 15) == 0) {
    const int cpr = W >> 4;
    for (int k = threadIdx.x; k < nrows * cpr; k += blockDim.x) {
      const int row = k / cpr;
      const int c = (k - row * cpr) << 4;
      NYX_ST3_ROW(row)
      nyx_cp16(ps + srow * g.PB + NYX_ST3_XB + c, pb + grow * W + c);
    }
  } else if ((W & 3) == 0 && (pa & 3) == 0) {
    const int cpr = W >> 2;
    for (int k = threadIdx.x; k < nrows * cpr; k += blockDim.x) {
      const int row = k / cpr;
      const int c = (k - row * cpr) << 2;
      NYX_ST3_ROW(row)
      nyx_cp4(ps + srow * g.PB + NYX_ST3_XB + c, pb + grow * W + c);
    }
  } else {
    for (int k = threadIdx.x; k < nrows * W; k += blockDim.x) {
      const int row = k / W;
      const int c = k - row * W;
      NYX_ST3_ROW(row)
      ps[srow * g.PB + NYX_ST3_XB + c] = pb[grow * W + c];
    }
  }
#undef NYX_ST3_ROW
  nyx_cp_wait();
  __syncthreads();
}

// TABLE: count the shifts of MASK (0: the mask ``mrt`` given at run time)
// with R = 1; else the window of radius R
template <bool TABLE, int R, unsigned int MASK>
__global__ void __launch_bounds__(NYX_ST3_THREADS_MAX)
    stencil3d_slab_kernel(const int* __restrict__ lev,
                          const unsigned char* __restrict__ part,
                          int* __restrict__ same, int* __restrict__ nsum,
                          int* __restrict__ ncnt, NyxSlab g,
                          unsigned int mrt) {
  extern __shared__ __align__(16) int sm[];
  const int planes = g.Zt + 2 * R;
  int* ls = sm;
  unsigned char* ps =
      reinterpret_cast<unsigned char*>(sm + planes * g.rows * g.PL);
  const int per = g.nz * g.ny;
  const int b = blockIdx.x / per;
  const int t = blockIdx.x - b * per;
  const int zi = t / g.ny;
  const int z0 = zi * g.Zt;
  const int y0 = (t - zi * g.ny) * g.Yt;
  const int HW = g.H * g.W;
  const size_t rb = static_cast<size_t>(b) * g.D * HW;
  st3_stage<R>(lev + rb, part + rb, ls, ps, g, z0, y0);
  const int zc = min(g.Zt, g.D - z0);
  const int ncol = min(g.Yt, g.H - y0) * g.W;
  const int LP = g.rows * g.PL;  // plane strides of the stage
  const int BP = g.rows * g.PB;
  const size_t ob = rb + static_cast<size_t>(z0) * HW + y0 * g.W;
  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    const int y = c / g.W;
    const int x = c - y * g.W;
    // plane 0, row y, column x of the stage (its halo before it)
    const int* lc = ls + (y + R) * g.PL + NYX_ST3_XL + x;
    const unsigned char* pc = ps + (y + R) * g.PB + NYX_ST3_XB + x;
    if constexpr (TABLE) {
      int lv[27];
      unsigned int pv = 0;  // part bit q of neighbourhood position q
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const int o = (j / 3 - 1) * g.PL + j % 3 - 1;
          const int ob8 = (j / 3 - 1) * g.PB + j % 3 - 1;
          lv[9 * s + 9 + j] = lc[s * LP + o];
          pv |= static_cast<unsigned int>(pc[s * BP + ob8] != 0)
                << (9 * s + 9 + j);
        }
      }
      for (int k = 0; k < zc; ++k) {
#pragma unroll
        for (int q = 0; q < 18; ++q) lv[q] = lv[q + 9];
        pv >>= 9;
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const int o = (j / 3 - 1) * g.PL + j % 3 - 1;
          const int ob8 = (j / 3 - 1) * g.PB + j % 3 - 1;
          lv[18 + j] = lc[(k + 2) * LP + o];
          pv |= static_cast<unsigned int>(pc[(k + 2) * BP + ob8] != 0)
                << (18 + j);
        }
        const int cv = lv[13];
        unsigned int e = 0;
#pragma unroll
        for (int q = 0; q < 27; ++q)
          if (q != 13) e |= static_cast<unsigned int>(lv[q] == cv) << q;
        same[ob + k * HW + c] = __popc(e & pv & (MASK ? MASK : mrt));
      }
    } else {
      constexpr int S = 2 * R + 1;
      unsigned int rs[S];  // the last S plane sums of masked levels
      int rc[S];           // and of part bits
      for (int k = -2 * R; k < zc; ++k) {
#pragma unroll
        for (int q = 0; q + 1 < S; ++q) {
          rs[q] = rs[q + 1];
          rc[q] = rc[q + 1];
        }
        const int p = k + 2 * R;  // the stage's plane entering the window
        unsigned int s = 0;
        int n = 0;
#pragma unroll
        for (int dy = -R; dy <= R; ++dy)
#pragma unroll
          for (int dx = -R; dx <= R; ++dx) {
            const bool on = pc[p * BP + dy * g.PB + dx] != 0;
            s += on ? static_cast<unsigned int>(lc[p * LP + dy * g.PL + dx])
                    : 0u;
            n += on;
          }
        rs[S - 1] = s;
        rc[S - 1] = n;
        if (k < 0) continue;
        const bool on = pc[(k + R) * BP] != 0;  // the centre
        s = on ? 0u - static_cast<unsigned int>(lc[(k + R) * LP]) : 0u;
        n = -static_cast<int>(on);
#pragma unroll
        for (int q = 0; q < S; ++q) {
          s += rs[q];
          n += rc[q];
        }
        nsum[ob + k * HW + c] = static_cast<int>(s);
        ncnt[ob + k * HW + c] = n;
      }
    }
  }
}

template <bool TABLE, int R, unsigned int MASK>
static int st3_launch(const void* lev, const void* part, void* same,
                      void* nsum, void* ncnt, const NyxSlab& g, int B, int T,
                      size_t smem, unsigned int mask, cudaStream_t st) {
  auto kern = stencil3d_slab_kernel<TABLE, R, MASK>;
  static NyxClusterAttrs done;
  cudaError_t e = nyx_allow_cluster(kern, smem, 1, &done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(B) * g.nz * g.ny;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned int>(blocks), T, smem, st>>>(
      static_cast<const int*>(lev), static_cast<const unsigned char*>(part),
      static_cast<int*>(same), static_cast<int*>(nsum),
      static_cast<int*>(ncnt), g, mask);
  return static_cast<int>(cudaGetLastError());
}

// shifts: host int[3 * n] (dz, dy, dx) for the table mode (n <= 26), NULL
// for the window mode of radius ``rad`` (then nsum and ncnt are written,
// else same).  Zt = 0: the voxel path; else the slab path with tiles of Zt
// planes and Yt rows, T threads and ``smem`` bytes of shared memory, the
// table given as ``mask`` (ops/texture3d.py stencil3d_plan).
extern "C" int nyx_stencil3d(const void* lev, const void* part,
                             const void* shifts, int n, int mask, int rad,
                             void* same, void* nsum, void* ncnt, int B, int D,
                             int H, int W, int Zt, int Yt, int T, int smem,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Zt > 0) {
    const int R = shifts != nullptr ? 1 : rad;
    NyxSlab g;
    g.D = D;
    g.H = H;
    g.W = W;
    g.Zt = Zt;
    g.Yt = Yt;
    g.nz = (D + Zt - 1) / Zt;
    g.ny = (H + Yt - 1) / Yt;
    g.PL = (W + 3) / 4 * 4 + 2 * NYX_ST3_XL;
    g.PB = (W + 15) / 16 * 16 + 2 * NYX_ST3_XB;
    g.rows = Yt + 2 * R;
    const long long need =
        static_cast<long long>(Zt + 2 * R) * g.rows * (4 * g.PL + g.PB);
    if (R < 1 || R > 2 || Yt < 1 || T < 32 || T > NYX_ST3_THREADS_MAX ||
        T % 32 || smem < need || (shifts != nullptr && mask < 0))
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned int m = static_cast<unsigned int>(mask);
    if (shifts != nullptr) {
      if (m == NYX_ST3_N26)
        return st3_launch<true, 1, NYX_ST3_N26>(lev, part, same, nsum, ncnt,
                                                g, B, T, smem, m, s);
      if (m == NYX_ST3_N24)
        return st3_launch<true, 1, NYX_ST3_N24>(lev, part, same, nsum, ncnt,
                                                g, B, T, smem, m, s);
      return st3_launch<true, 1, 0u>(lev, part, same, nsum, ncnt, g, B, T,
                                     smem, m & NYX_ST3_N26, s);
    }
    if (R == 1)
      return st3_launch<false, 1, 0u>(lev, part, same, nsum, ncnt, g, B, T,
                                      smem, 0u, s);
    return st3_launch<false, 2, 0u>(lev, part, same, nsum, ncnt, g, B, T,
                                    smem, 0u, s);
  }
  const long long total = static_cast<long long>(B) * D * H * W;
  long long blocks = (total + NYX_BLOCK - 1) / NYX_BLOCK;
  if (blocks > 1048576) blocks = 1048576;
  const unsigned int nb = static_cast<unsigned int>(blocks);
  if (shifts != nullptr) {
    if (n < 0 || n > 26) return static_cast<int>(cudaErrorInvalidValue);
    NyxShifts sh;
    sh.n = n;
    const int* v = static_cast<const int*>(shifts);
    for (int k = 0; k < n; ++k) {
      sh.dz[k] = v[3 * k];
      sh.dy[k] = v[3 * k + 1];
      sh.dx[k] = v[3 * k + 2];
    }
    stencil3d_table_kernel<<<nb, NYX_BLOCK, 0, s>>>(
        static_cast<const int*>(lev), static_cast<const unsigned char*>(part),
        static_cast<int*>(same), total, D, H, W, sh);
  } else {
    stencil3d_window_kernel<<<nb, NYX_BLOCK, 0, s>>>(
        static_cast<const int*>(lev), static_cast<const unsigned char*>(part),
        static_cast<int*>(nsum), static_cast<int*>(ncnt), total, D, H, W, rad);
  }
  return static_cast<int>(cudaGetLastError());
}
