// K17 ih_stats: the 46 IBSI intensity-histogram statistics of each ROI from
// its N-bin frequency table (N >= 2),
//   out[b, :] = the members of nyxus_tpu_torch/ops/ih.py MEMBERS, in order,
// with `noval` on rows whose max <= min or whose pixel count is 0.
//
// Replaces nyxus_tpu/ops/ih.py:132 ih_features_from_freq (with its quantile
// scans :62,80), about a hundred small [B, N] array operations, with one
// launch.  Every term is formed in the input type T with the JAX package's
// operations in its order, each product, sum and quotient rounded on its own
// (no FMA contraction), so each term equals the plain version's; every sum
// accumulates in double, as the plain version's does, and only the order of
// those sums differs.
//
// Design (ops/ih.py ih_stats_plan picks the path):
// - "warp", N <= 128 (past which the block path measured faster): a block
//   of one warp a ROI, no shared memory and no block barrier.  Lane l holds
//   the K = 1, 2 or 4 >= N / 32 contiguous bins [l K, l K + K) in
//   registers.  The running counts are a
//   lane-serial sum plus one 5-shuffle exclusive scan of the lane totals, in
//   double (exact for integer counts).  The landing bins -- the median bin
//   (first cum > floor(n/2)), p10/p25 (first cum >= p n) and p75/p90 (last
//   bin whose preceding cum <= p n) -- are each lane's first (last) hit, the
//   warp's by __ballot_sync and __ffs / __clz, its values broadcast by one
//   shuffle from that lane; then lanes 0-3 interpolate the four quantiles
//   and lanes 0-6 find the bin indices of those and of the median, minimum
//   and maximum at once.  The mode (first maximal bin) and the first strict
//   maximum and minimum of the histogram gradient keep the first index: in
//   float32 one integer reduction (__reduce_max_sync) of keys that order as
//   the values and a ballot of the lanes that reach it, in float64 (value,
//   index) butterflies; a lane's edge bins reach its neighbours by one
//   shuffle each way.  Passes B (5 sums) and C
//   (14 sums) run over the registers and reduce through nyx_reduce_scatter,
//   the lane holding a total shuffling it to all.  Every lane then forms the
//   row and keeps its member by selects: lane l writes member l and, below
//   14, member 32 + l, one coalesced store of the row.
// - "block" / "device": one block a ROI, the row staged in
//   dynamic shared memory ("block") or read from device memory ("device").
//   Pass A walks the row in tiles of the block's width: a block scan gives
//   each bin its running count, and the one bin where a condition first
//   holds records itself, while each thread keeps the first maximal bin and
//   the first strict gradient extrema; one thread then forms the medians,
//   the interpolated quantiles and the bin indices; passes B and C are block
//   sums.
// Pass C forms the central moments, the absolute deviations, the entropy
// (exact log2, guarded at p > 1e-7) and the uniformity.  Bound on the card:
// the ~60 operations of a bin; at the main path's N = 64 a launch and the
// warp's chain of dependent steps.
#include <float.h>

#include "common.cuh"

#define IH_BLOCK 256
#define IH_WARPS (IH_BLOCK / 32)
#define IH_MEMBERS 46
#define IH_SUMS 14

__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double rn_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double rn_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double rn_sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T> struct IhLimits;
template <> struct IhLimits<float> {
  __device__ static float seed_min() { return FLT_MIN; }
  __device__ static float seed_max() { return FLT_MAX; }
};
template <> struct IhLimits<double> {
  __device__ static double seed_min() { return DBL_MIN; }
  __device__ static double seed_max() { return DBL_MAX; }
};

template <typename T>
__device__ __forceinline__ T safe_div(T a, T b) {
  return b != T(0) ? a / b : T(0);
}

// bin centre min + (i + 0.5) binw, as the JAX package forms it
template <typename T>
__device__ __forceinline__ T centre(T mn, int i, T binw) {
  return rn_add(mn, rn_mul(rn_add(static_cast<T>(i), T(0.5)), binw));
}

// clip(floor((v - min) / binw), 0, N - 1) (0 where binw == 0)
template <typename T>
__device__ __forceinline__ T index_of(T v, T mn, T binw, int N) {
  T k = floor(safe_div(rn_sub(v, mn), binw));
  return fmin(fmax(k, T(0)), static_cast<T>(N - 1));
}

// (value, index) reductions that keep the first index among equal values
template <typename T>
__device__ __forceinline__ void keep_max(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}
template <typename T>
__device__ __forceinline__ void keep_min(T& v, int& i, T v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

template <typename T>
struct IhShared {
  double wsum[IH_WARPS];
  double red[IH_WARPS][IH_SUMS];
  T mode_v[IH_WARPS], gmax_v[IH_WARPS], gmin_v[IH_WARPS];
  int mode_i[IH_WARPS], gmax_i[IH_WARPS], gmin_i[IH_WARPS];
  int med_bin;
  int low_s[2], low_found[2];   // p10, p25
  T low_cprev[2], low_f[2];
  T last_cprev, last_f;         // bin N - 1, for a lower scan that ends there
  int high_s[2];                // p75, p90
  T high_c[2], high_f[2];
  // results of pass A, then of pass B
  T median_v, median_i, p10_v, p25_v, p75_v, p90_v;
  T p10_i, p25_i, p75_i, p90_i, min_i, max_i;
  T mode_bin, gmax, gmax_idx, gmin, gmin_idx;
  T mean_v, mean_i, rob_cnt, rmean_v, rmean_i;
};

// block sum of IH_SUMS doubles (every thread passes its partials); the
// totals land in sh.red[0][*], valid after the trailing barrier
template <typename T>
__device__ void block_sums(double (&acc)[IH_SUMS], IhShared<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < IH_SUMS; ++k) {
    double u = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      u += __shfl_down_sync(0xffffffffu, u, off);
    if (lane == 0) sh.red[warp][k] = u;
  }
  __syncthreads();
  if (threadIdx.x < IH_SUMS) {
    double u = 0.0;
    for (int w = 0; w < IH_WARPS; ++w) u += sh.red[w][threadIdx.x];
    sh.red[0][threadIdx.x] = u;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(IH_BLOCK)
    ih_stats_block_kernel(const T* __restrict__ freq, const T* __restrict__ counts,
                    const T* __restrict__ vmin, const T* __restrict__ vmax,
                    const T* __restrict__ pscale, const T* __restrict__ poffset,
                    T* __restrict__ out, int N, int staged, T noval) {
  extern __shared__ __align__(16) unsigned char ih_dyn[];
  __shared__ IhShared<T> sh;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* f = freq + static_cast<size_t>(b) * N;
  if (staged) {
    T* s = reinterpret_cast<T*>(ih_dyn);
    for (int i = tid; i < N; i += IH_BLOCK) s[i] = f[i];
    f = s;
  }

  const T total = counts[b];
  const bool bad = (vmax[b] <= vmin[b]) || (total == T(0));
  const T safe_total = fmax(total, T(1));
  const T min_val = rn_add(poffset[b], rn_mul(pscale[b], vmin[b]));
  const T max_val = rn_add(poffset[b], rn_mul(pscale[b], vmax[b]));
  const T binw = rn_sub(max_val, min_val) / static_cast<T>(N);
  const T half = floor(total / T(2));
  const T tgt_low[2] = {rn_mul(safe_total, T(0.10)), rn_mul(safe_total, T(0.25))};
  const T tgt_high[2] = {rn_mul(safe_total, T(0.75)), rn_mul(safe_total, T(0.90))};

  if (tid == 0) {
    sh.med_bin = 0;
    sh.low_found[0] = sh.low_found[1] = 0;
  }
  __syncthreads();

  // ---- pass A: scan, landing bins, mode, gradient extrema
  T mode_v = -INFINITY, gmax_v = -INFINITY, gmin_v = INFINITY;
  int mode_i = N, gmax_i = N, gmin_i = N;
  double carry = 0.0;
  for (int base = 0; base < N; base += IH_BLOCK) {
    const int i = base + tid;
    const T v = i < N ? f[i] : T(0);
    double x = static_cast<double>(v);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) sh.wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      double w = lane < IH_WARPS ? sh.wsum[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < IH_WARPS; off <<= 1) {
        const double y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      if (lane < IH_WARPS) sh.wsum[lane] = w;
    }
    __syncthreads();
    const double incl = carry + x + (warp > 0 ? sh.wsum[warp - 1] : 0.0);
    const double tile = sh.wsum[IH_WARPS - 1];
    __syncthreads();   // wsum is rewritten by the next tile
    carry += tile;
    if (i < N) {
      const T cum = static_cast<T>(incl);
      const T prev = static_cast<T>(incl - static_cast<double>(v));
      if (cum > half && prev <= half) sh.med_bin = i;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (cum >= tgt_low[q] && (i == 0 || prev < tgt_low[q])) {
          sh.low_s[q] = i;
          sh.low_found[q] = 1;
          sh.low_cprev[q] = prev;
          sh.low_f[q] = v;
        }
        if (prev <= tgt_high[q] && (i == N - 1 || cum > tgt_high[q])) {
          sh.high_s[q] = i;
          sh.high_c[q] = cum;
          sh.high_f[q] = v;
        }
      }
      if (i == N - 1) {
        sh.last_cprev = prev;
        sh.last_f = v;
      }
      if (v > mode_v) { mode_v = v; mode_i = i; }
      T g;
      if (i == 0)
        g = rn_sub(f[1], f[0]);
      else if (i == N - 1)
        g = rn_sub(f[N - 1], f[N - 2]);
      else
        g = rn_sub(f[i + 1], f[i - 1]) / T(2);
      if (g > gmax_v) { gmax_v = g; gmax_i = i; }
      if (g < gmin_v) { gmin_v = g; gmin_i = i; }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    keep_max(mode_v, mode_i, __shfl_down_sync(0xffffffffu, mode_v, off),
             __shfl_down_sync(0xffffffffu, mode_i, off));
    keep_max(gmax_v, gmax_i, __shfl_down_sync(0xffffffffu, gmax_v, off),
             __shfl_down_sync(0xffffffffu, gmax_i, off));
    keep_min(gmin_v, gmin_i, __shfl_down_sync(0xffffffffu, gmin_v, off),
             __shfl_down_sync(0xffffffffu, gmin_i, off));
  }
  if (lane == 0) {
    sh.mode_v[warp] = mode_v; sh.mode_i[warp] = mode_i;
    sh.gmax_v[warp] = gmax_v; sh.gmax_i[warp] = gmax_i;
    sh.gmin_v[warp] = gmin_v; sh.gmin_i[warp] = gmin_i;
  }
  __syncthreads();

  if (tid == 0) {
    for (int w = 1; w < IH_WARPS; ++w) {
      keep_max(mode_v, mode_i, sh.mode_v[w], sh.mode_i[w]);
      keep_max(gmax_v, gmax_i, sh.gmax_v[w], sh.gmax_i[w]);
      keep_min(gmin_v, gmin_i, sh.gmin_v[w], sh.gmin_i[w]);
    }
    sh.mode_bin = static_cast<T>(mode_i);
    sh.gmax = gmax_v;
    sh.gmax_idx = static_cast<T>(gmax_i + 1);
    sh.gmin = gmin_v;
    sh.gmin_idx = static_cast<T>(gmin_i + 1);

    sh.median_v = centre(min_val, sh.med_bin, binw);
    sh.median_i = index_of(sh.median_v, min_val, binw, N);
    T pv[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      // lower tail: mn + (p - c_prev / n) / (f_s / n) * binw
      const int s = sh.low_found[q] ? sh.low_s[q] : N - 1;
      const T cprev = sh.low_found[q] ? sh.low_cprev[q] : sh.last_cprev;
      const T fs = sh.low_found[q] ? sh.low_f[q] : sh.last_f;
      const T p = q == 0 ? T(0.10) : T(0.25);
      const T mn = rn_add(min_val, rn_mul(static_cast<T>(s), binw));
      pv[q] = rn_add(mn, rn_mul(safe_div(rn_sub(p, cprev / safe_total),
                                         fs / safe_total), binw));
      // upper tail: mx - (c_s / n - p) / (f_s / n) * binw
      const int t = sh.high_s[q];
      const T ph = q == 0 ? T(0.75) : T(0.90);
      const T mx = rn_add(min_val, rn_mul(rn_add(static_cast<T>(t), T(1)), binw));
      pv[2 + q] = rn_sub(mx, rn_mul(safe_div(rn_sub(sh.high_c[q] / safe_total, ph),
                                             sh.high_f[q] / safe_total), binw));
    }
    sh.p10_v = pv[0];
    sh.p25_v = pv[1];
    sh.p75_v = pv[2];
    sh.p90_v = pv[3];
    sh.p10_i = index_of(pv[0], min_val, binw, N);
    sh.p25_i = index_of(pv[1], min_val, binw, N);
    sh.p75_i = index_of(pv[2], min_val, binw, N);
    sh.p90_i = index_of(pv[3], min_val, binw, N);
    sh.min_i = index_of(min_val, min_val, binw, N);
    sh.max_i = index_of(max_val, min_val, binw, N);
  }
  __syncthreads();

  // ---- pass B: means and the robust window's means
  const T p10_i = sh.p10_i, p90_i = sh.p90_i;
  double acc[IH_SUMS];
#pragma unroll
  for (int k = 0; k < IH_SUMS; ++k) acc[k] = 0.0;
  for (int i = tid; i < N; i += IH_BLOCK) {
    const T v = f[i];
    const T ii = static_cast<T>(i);
    const T prob = v / safe_total;
    const T c = centre(min_val, i, binw);
    const T robw = (ii >= p10_i && ii <= p90_i) ? v : T(0);
    acc[0] += static_cast<double>(rn_mul(prob, c));
    acc[1] += static_cast<double>(rn_mul(prob, ii));
    acc[2] += static_cast<double>(robw);
    acc[3] += static_cast<double>(rn_mul(robw, c));
    acc[4] += static_cast<double>(rn_mul(robw, ii));
  }
  block_sums(acc, sh);
  if (tid == 0) {
    sh.mean_v = static_cast<T>(sh.red[0][0]);
    sh.mean_i = static_cast<T>(sh.red[0][1]);
    sh.rob_cnt = static_cast<T>(sh.red[0][2]);
    sh.rmean_v = safe_div(static_cast<T>(sh.red[0][3]), sh.rob_cnt);
    sh.rmean_i = safe_div(static_cast<T>(sh.red[0][4]), sh.rob_cnt);
  }
  __syncthreads();

  // ---- pass C: central moments, deviations, entropy, uniformity
  const T mean_v = sh.mean_v, mean_i = sh.mean_i;
  const T rmean_v = sh.rmean_v, rmean_i = sh.rmean_i;
  const T median_v = sh.median_v, median_i = sh.median_i;
#pragma unroll
  for (int k = 0; k < IH_SUMS; ++k) acc[k] = 0.0;
  for (int i = tid; i < N; i += IH_BLOCK) {
    const T v = f[i];
    const T ii = static_cast<T>(i);
    const T prob = v / safe_total;
    const T c = centre(min_val, i, binw);
    const T robw = (ii >= p10_i && ii <= p90_i) ? v : T(0);
    const T dv = rn_sub(c, mean_v);
    const T di = rn_sub(ii, mean_i);
    const T dv2 = rn_mul(dv, dv), di2 = rn_mul(di, di);
    acc[0] += static_cast<double>(rn_mul(rn_mul(prob, dv), dv));
    acc[1] += static_cast<double>(rn_mul(rn_mul(prob, di), di));
    acc[2] += static_cast<double>(rn_mul(prob, rn_mul(dv, dv2)));
    acc[3] += static_cast<double>(rn_mul(prob, rn_mul(di, di2)));
    acc[4] += static_cast<double>(rn_mul(prob, rn_mul(dv2, dv2)));
    acc[5] += static_cast<double>(rn_mul(prob, rn_mul(di2, di2)));
    acc[6] += static_cast<double>(rn_mul(prob, fabs(dv)));
    acc[7] += static_cast<double>(rn_mul(prob, fabs(di)));
    acc[8] += static_cast<double>(rn_mul(robw, fabs(rn_sub(c, rmean_v))));
    acc[9] += static_cast<double>(rn_mul(robw, fabs(rn_sub(ii, rmean_i))));
    acc[10] += static_cast<double>(rn_mul(prob, fabs(rn_sub(c, median_v))));
    acc[11] += static_cast<double>(rn_mul(prob, fabs(rn_sub(ii, median_i))));
    if (prob > static_cast<T>(1e-7))
      acc[12] += static_cast<double>(rn_mul(prob, log2(prob)));
    acc[13] += static_cast<double>(rn_mul(prob, prob));
  }
  block_sums(acc, sh);

  if (tid == 0) {
    const double* s = sh.red[0];
    const T var_v = static_cast<T>(s[0]);
    const T var_i = static_cast<T>(s[1]);
    const T rob_cnt = sh.rob_cnt;
    const T p10_v = sh.p10_v, p25_v = sh.p25_v, p75_v = sh.p75_v,
            p90_v = sh.p90_v;
    const T p25_i = sh.p25_i, p75_i = sh.p75_i;
    const T min_i = sh.min_i, max_i = sh.max_i;
    const T entropy = -static_cast<T>(s[12]);
    const T uniformity = static_cast<T>(s[13]);
    const T seed_min = IhLimits<T>::seed_min();
    const T seed_max = IhLimits<T>::seed_max();
    const bool up = sh.gmax > seed_min;
    const bool down = sh.gmin < seed_max;
    T r[IH_MEMBERS];
    r[0] = mean_v;
    r[1] = var_v;
    r[2] = safe_div(static_cast<T>(s[2]), rn_mul(var_v, sqrt(var_v)));
    r[3] = rn_sub(safe_div(static_cast<T>(s[4]), rn_mul(var_v, var_v)), T(3));
    r[4] = median_v;
    r[5] = min_val;
    r[6] = p10_v;
    r[7] = p90_v;
    r[8] = max_val;
    r[9] = centre(min_val, static_cast<int>(sh.mode_bin), binw);
    r[10] = rn_sub(p75_v, p25_v);
    r[11] = rn_sub(max_val, min_val);
    r[12] = static_cast<T>(s[6]);
    r[13] = safe_div(static_cast<T>(s[8]), rob_cnt);
    r[14] = static_cast<T>(s[10]);
    r[15] = safe_div(sqrt(var_v), mean_v);
    r[16] = safe_div(rn_sub(p75_v, p25_v), rn_add(p75_v, p25_v));
    r[17] = entropy;
    r[18] = uniformity;
    r[19] = rmean_v;
    r[20] = rn_add(mean_i, T(1));
    r[21] = var_i;
    r[22] = safe_div(static_cast<T>(s[3]), rn_mul(var_i, sqrt(var_i)));
    r[23] = rn_sub(safe_div(static_cast<T>(s[5]), rn_mul(var_i, var_i)), T(3));
    r[24] = rn_add(median_i, T(1));
    r[25] = rn_add(min_i, T(1));
    r[26] = rn_add(p10_i, T(1));
    r[27] = rn_add(sh.p90_i, T(1));
    r[28] = rn_add(max_i, T(1));
    r[29] = rn_add(sh.mode_bin, T(1));
    r[30] = rn_sub(p75_i, p25_i);
    r[31] = rn_sub(max_i, min_i);
    r[32] = static_cast<T>(s[7]);
    r[33] = safe_div(static_cast<T>(s[9]), rob_cnt);
    r[34] = static_cast<T>(s[11]);
    r[35] = safe_div(sqrt(var_i), rn_add(mean_i, T(1)));
    r[36] = safe_div(rn_sub(p75_i, p25_i), rn_add(rn_add(p75_i, p25_i), T(2)));
    r[37] = entropy;
    r[38] = uniformity;
    r[39] = up ? sh.gmax : seed_min;
    r[40] = up ? sh.gmax_idx : T(0);
    r[41] = down ? sh.gmin : seed_max;
    r[42] = down ? sh.gmin_idx : T(0);
    r[43] = rmean_i;
    r[44] = static_cast<T>(N);
    r[45] = binw;
    T* o = out + static_cast<size_t>(b) * IH_MEMBERS;
    for (int k = 0; k < IH_MEMBERS; ++k) o[k] = bad ? noval : r[k];
  }
}


// ---- the warp path: one warp a ROI, K bins a lane

// an int that orders as the float v does (finite v, -0 read as +0)
__device__ __forceinline__ int ih_key(float v) {
  const int b = __float_as_int(v + 0.0f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// the warp's first maximal (value, index) over lanes that hold increasing
// bins, each lane's pair its own first maximum: float32 by one integer
// reduction of ordered keys and a ballot of the lanes that reach it
__device__ __forceinline__ void ih_first_max(float& v, int& i, bool min) {
  const int k = min ? ~ih_key(v) : ih_key(v);
  const int top = __reduce_max_sync(NYX_FULL, k);
  const int src = __ffs(__ballot_sync(NYX_FULL, k == top)) - 1;
  v = __shfl_sync(NYX_FULL, v, src);
  i = __shfl_sync(NYX_FULL, i, src);
}

// float64 by butterflies of (value, index) that keep the first index
__device__ __forceinline__ void ih_first_max(double& v, int& i, bool min) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double v2 = __shfl_xor_sync(NYX_FULL, v, off);
    const int i2 = __shfl_xor_sync(NYX_FULL, i, off);
    if (min)
      keep_min(v, i, v2, i2);
    else
      keep_max(v, i, v2, i2);
  }
}

// the mode (first maximal bin) and the first strict maximum and minimum of
// the gradient, in every lane
template <typename T>
__device__ __forceinline__ void ih_warp_extrema(T& mode_v, int& mode_i,
                                                T& gmax_v, int& gmax_i,
                                                T& gmin_v, int& gmin_i) {
  ih_first_max(mode_v, mode_i, false);
  ih_first_max(gmax_v, gmax_i, false);
  ih_first_max(gmin_v, gmin_i, true);
}

template <typename T, int K>
__global__ void __launch_bounds__(32)
    ih_stats_warp_kernel(const T* __restrict__ freq,
                         const T* __restrict__ counts,
                         const T* __restrict__ vmin, const T* __restrict__ vmax,
                         const T* __restrict__ pscale,
                         const T* __restrict__ poffset, T* __restrict__ out,
                         int N, T noval) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const T* f = freq + static_cast<size_t>(b) * N;
  const int i0 = lane * K;
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = i0 + k < N ? f[i0 + k] : T(0);

  const T total = counts[b];
  const bool bad = (vmax[b] <= vmin[b]) || (total == T(0));
  const T safe_total = fmax(total, T(1));
  const T min_val = rn_add(poffset[b], rn_mul(pscale[b], vmin[b]));
  const T max_val = rn_add(poffset[b], rn_mul(pscale[b], vmax[b]));
  const T binw = rn_sub(max_val, min_val) / static_cast<T>(N);
  const T half = floor(total / T(2));
  const T tgt_low[2] = {rn_mul(safe_total, T(0.10)), rn_mul(safe_total, T(0.25))};
  const T tgt_high[2] = {rn_mul(safe_total, T(0.75)), rn_mul(safe_total, T(0.90))};

  // ---- pass A: running counts, landing bins, mode, gradient extrema
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) run += static_cast<double>(v[k]);
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(NYX_FULL, incl, off);
    if (lane >= off) incl += y;
  }
  incl -= run;  // the lane's exclusive start (exact for integer counts)
  const T left = __shfl_up_sync(NYX_FULL, v[K - 1], 1);  // bin i0 - 1
  const T right = __shfl_down_sync(NYX_FULL, v[0], 1);   // bin i0 + K
  int med_s = -1, low_s[2] = {-1, -1}, high_s[2] = {-1, -1};
  T low_cprev[2] = {T(0), T(0)}, low_f[2] = {T(0), T(0)};
  T high_c[2] = {T(0), T(0)}, high_f[2] = {T(0), T(0)};
  T last_cprev = T(0), last_c = T(0), last_f = T(0);  // bin N - 1
  T mode_v = -INFINITY, gmax_v = -INFINITY, gmin_v = INFINITY;
  int mode_i = N, gmax_i = N, gmin_i = N;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    incl += static_cast<double>(v[k]);
    if (i < N) {
      const T cum = static_cast<T>(incl);
      const T prev = static_cast<T>(incl - static_cast<double>(v[k]));
      if (med_s < 0 && cum > half) med_s = i;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (low_s[q] < 0 && cum >= tgt_low[q]) {
          low_s[q] = i;
          low_cprev[q] = prev;
          low_f[q] = v[k];
        }
        if (prev <= tgt_high[q]) {
          high_s[q] = i;
          high_c[q] = cum;
          high_f[q] = v[k];
        }
      }
      if (i == N - 1) {
        last_cprev = prev;
        last_c = cum;
        last_f = v[k];
      }
      if (v[k] > mode_v) { mode_v = v[k]; mode_i = i; }
      const T fm = k > 0 ? v[k > 0 ? k - 1 : 0] : left;
      const T fp = k < K - 1 ? v[k < K - 1 ? k + 1 : k] : right;
      T g;
      if (i == 0)
        g = rn_sub(fp, v[k]);
      else if (i == N - 1)
        g = rn_sub(v[k], fm);
      else
        g = rn_sub(fp, fm) / T(2);
      if (g > gmax_v) { gmax_v = g; gmax_i = i; }
      if (g < gmin_v) { gmin_v = g; gmin_i = i; }
    }
  }
  ih_warp_extrema(mode_v, mode_i, gmax_v, gmax_i, gmin_v, gmin_i);
  // the warp's first (last) hit: the lowest (highest) lane with one; the
  // inputs of quantile j (p10, p25, p75, p90): its bin, the running count
  // before it (lower tail) or at it (upper tail), its count
  const int last_lane = (N - 1) / K;
  unsigned int hits = __ballot_sync(NYX_FULL, med_s >= 0);
  const int med_bin = hits ? __shfl_sync(NYX_FULL, med_s, __ffs(hits) - 1) : 0;
  const T median_v = centre(min_val, med_bin, binw);
  int qs[4];
  T qc[4], qf[4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // lower tail: at bin N - 1 where no bin reaches p n
    hits = __ballot_sync(NYX_FULL, low_s[q] >= 0);
    int src = hits ? __ffs(hits) - 1 : last_lane;
    qs[q] = hits ? __shfl_sync(NYX_FULL, low_s[q], src) : N - 1;
    qc[q] = __shfl_sync(NYX_FULL, hits ? low_cprev[q] : last_cprev, src);
    qf[q] = __shfl_sync(NYX_FULL, hits ? low_f[q] : last_f, src);
    hits = __ballot_sync(NYX_FULL, high_s[q] >= 0);
    src = hits ? 31 - __clz(hits) : last_lane;
    qs[2 + q] = hits ? __shfl_sync(NYX_FULL, high_s[q], src) : N - 1;
    qc[2 + q] = __shfl_sync(NYX_FULL, hits ? high_c[q] : last_c, src);
    qf[2 + q] = __shfl_sync(NYX_FULL, hits ? high_f[q] : last_f, src);
  }
  // lane j < 4 interpolates quantile j, lanes 4, 5 and 6 take the median,
  // the minimum and the maximum; each lane then its value's bin index, and
  // one shuffle a value hands them to the warp
  const int j = lane & 7;
  T val;
  if (j < 4) {
    const int s = j == 0 ? qs[0] : j == 1 ? qs[1] : j == 2 ? qs[2] : qs[3];
    const T c = j == 0 ? qc[0] : j == 1 ? qc[1] : j == 2 ? qc[2] : qc[3];
    const T f = j == 0 ? qf[0] : j == 1 ? qf[1] : j == 2 ? qf[2] : qf[3];
    if (j < 2) {
      // lower tail: mn + (p - c_prev / n) / (f_s / n) * binw
      const T p = j == 0 ? T(0.10) : T(0.25);
      const T mn = rn_add(min_val, rn_mul(static_cast<T>(s), binw));
      val = rn_add(mn, rn_mul(safe_div(rn_sub(p, c / safe_total),
                                        f / safe_total), binw));
    } else {
      // upper tail: mx - (c_s / n - p) / (f_s / n) * binw
      const T ph = j == 2 ? T(0.75) : T(0.90);
      const T mx = rn_add(min_val, rn_mul(rn_add(static_cast<T>(s), T(1)),
                                          binw));
      val = rn_sub(mx, rn_mul(safe_div(rn_sub(c / safe_total, ph),
                                       f / safe_total), binw));
    }
  } else {
    val = j == 4 ? median_v : j == 5 ? min_val : max_val;
  }
  const T vidx = index_of(val, min_val, binw, N);
  const T p10_v = __shfl_sync(NYX_FULL, val, 0);
  const T p25_v = __shfl_sync(NYX_FULL, val, 1);
  const T p75_v = __shfl_sync(NYX_FULL, val, 2);
  const T p90_v = __shfl_sync(NYX_FULL, val, 3);
  const T p10_i = __shfl_sync(NYX_FULL, vidx, 0);
  const T p25_i = __shfl_sync(NYX_FULL, vidx, 1);
  const T p75_i = __shfl_sync(NYX_FULL, vidx, 2);
  const T p90_i = __shfl_sync(NYX_FULL, vidx, 3);
  const T median_i = __shfl_sync(NYX_FULL, vidx, 4);
  const T min_i = __shfl_sync(NYX_FULL, vidx, 5);
  const T max_i = __shfl_sync(NYX_FULL, vidx, 6);

  // ---- pass B: means and the robust window's means (5 sums; the total of
  // sum j lands on lane 4 j)
  double acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    if (i < N) {
      const T ii = static_cast<T>(i);
      const T prob = v[k] / safe_total;
      const T c = centre(min_val, i, binw);
      const T robw = (ii >= p10_i && ii <= p90_i) ? v[k] : T(0);
      acc[0] += static_cast<double>(rn_mul(prob, c));
      acc[1] += static_cast<double>(rn_mul(prob, ii));
      acc[2] += static_cast<double>(robw);
      acc[3] += static_cast<double>(rn_mul(robw, c));
      acc[4] += static_cast<double>(rn_mul(robw, ii));
    }
  }
  nyx_reduce_scatter<8>(acc, lane);
  const T mean_v = static_cast<T>(__shfl_sync(NYX_FULL, acc[0], 0));
  const T mean_i = static_cast<T>(__shfl_sync(NYX_FULL, acc[0], 4));
  const T rob_cnt = static_cast<T>(__shfl_sync(NYX_FULL, acc[0], 8));
  const T rmean_v =
      safe_div(static_cast<T>(__shfl_sync(NYX_FULL, acc[0], 12)), rob_cnt);
  const T rmean_i =
      safe_div(static_cast<T>(__shfl_sync(NYX_FULL, acc[0], 16)), rob_cnt);

  // ---- pass C: central moments, deviations, entropy, uniformity (14 sums;
  // the total of sum j lands on lane 2 j)
  double acc2[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc2[j] = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    if (i < N) {
      const T ii = static_cast<T>(i);
      const T prob = v[k] / safe_total;
      const T c = centre(min_val, i, binw);
      const T robw = (ii >= p10_i && ii <= p90_i) ? v[k] : T(0);
      const T dv = rn_sub(c, mean_v);
      const T di = rn_sub(ii, mean_i);
      const T dv2 = rn_mul(dv, dv), di2 = rn_mul(di, di);
      acc2[0] += static_cast<double>(rn_mul(rn_mul(prob, dv), dv));
      acc2[1] += static_cast<double>(rn_mul(rn_mul(prob, di), di));
      acc2[2] += static_cast<double>(rn_mul(prob, rn_mul(dv, dv2)));
      acc2[3] += static_cast<double>(rn_mul(prob, rn_mul(di, di2)));
      acc2[4] += static_cast<double>(rn_mul(prob, rn_mul(dv2, dv2)));
      acc2[5] += static_cast<double>(rn_mul(prob, rn_mul(di2, di2)));
      acc2[6] += static_cast<double>(rn_mul(prob, fabs(dv)));
      acc2[7] += static_cast<double>(rn_mul(prob, fabs(di)));
      acc2[8] += static_cast<double>(rn_mul(robw, fabs(rn_sub(c, rmean_v))));
      acc2[9] += static_cast<double>(rn_mul(robw, fabs(rn_sub(ii, rmean_i))));
      acc2[10] += static_cast<double>(rn_mul(prob, fabs(rn_sub(c, median_v))));
      acc2[11] += static_cast<double>(rn_mul(prob, fabs(rn_sub(ii, median_i))));
      if (prob > static_cast<T>(1e-7))
        acc2[12] += static_cast<double>(rn_mul(prob, log2(prob)));
      acc2[13] += static_cast<double>(rn_mul(prob, prob));
    }
  }
  nyx_reduce_scatter<16>(acc2, lane);
  double s[IH_SUMS];
#pragma unroll
  for (int j = 0; j < IH_SUMS; ++j) s[j] = __shfl_sync(NYX_FULL, acc2[0], 2 * j);

  // ---- the row: every lane forms it, lane l keeps members l and 32 + l
  const T var_v = static_cast<T>(s[0]);
  const T var_i = static_cast<T>(s[1]);
  const T entropy = -static_cast<T>(s[12]);
  const T uniformity = static_cast<T>(s[13]);
  const T seed_min = IhLimits<T>::seed_min();
  const T seed_max = IhLimits<T>::seed_max();
  const bool up = gmax_v > seed_min;
  const bool down = gmin_v < seed_max;
  const T mode_bin = static_cast<T>(mode_i);
  T r[IH_MEMBERS];
  r[0] = mean_v;
  r[1] = var_v;
  r[2] = safe_div(static_cast<T>(s[2]), rn_mul(var_v, sqrt(var_v)));
  r[3] = rn_sub(safe_div(static_cast<T>(s[4]), rn_mul(var_v, var_v)), T(3));
  r[4] = median_v;
  r[5] = min_val;
  r[6] = p10_v;
  r[7] = p90_v;
  r[8] = max_val;
  r[9] = centre(min_val, mode_i, binw);
  r[10] = rn_sub(p75_v, p25_v);
  r[11] = rn_sub(max_val, min_val);
  r[12] = static_cast<T>(s[6]);
  r[13] = safe_div(static_cast<T>(s[8]), rob_cnt);
  r[14] = static_cast<T>(s[10]);
  r[15] = safe_div(sqrt(var_v), mean_v);
  r[16] = safe_div(rn_sub(p75_v, p25_v), rn_add(p75_v, p25_v));
  r[17] = entropy;
  r[18] = uniformity;
  r[19] = rmean_v;
  r[20] = rn_add(mean_i, T(1));
  r[21] = var_i;
  r[22] = safe_div(static_cast<T>(s[3]), rn_mul(var_i, sqrt(var_i)));
  r[23] = rn_sub(safe_div(static_cast<T>(s[5]), rn_mul(var_i, var_i)), T(3));
  r[24] = rn_add(median_i, T(1));
  r[25] = rn_add(min_i, T(1));
  r[26] = rn_add(p10_i, T(1));
  r[27] = rn_add(p90_i, T(1));
  r[28] = rn_add(max_i, T(1));
  r[29] = rn_add(mode_bin, T(1));
  r[30] = rn_sub(p75_i, p25_i);
  r[31] = rn_sub(max_i, min_i);
  r[32] = static_cast<T>(s[7]);
  r[33] = safe_div(static_cast<T>(s[9]), rob_cnt);
  r[34] = static_cast<T>(s[11]);
  r[35] = safe_div(sqrt(var_i), rn_add(mean_i, T(1)));
  r[36] = safe_div(rn_sub(p75_i, p25_i), rn_add(rn_add(p75_i, p25_i), T(2)));
  r[37] = entropy;
  r[38] = uniformity;
  r[39] = up ? gmax_v : seed_min;
  r[40] = up ? static_cast<T>(gmax_i + 1) : T(0);
  r[41] = down ? gmin_v : seed_max;
  r[42] = down ? static_cast<T>(gmin_i + 1) : T(0);
  r[43] = rmean_i;
  r[44] = static_cast<T>(N);
  r[45] = binw;
  T lo = r[0], hi = r[32];
#pragma unroll
  for (int m = 1; m < 32; ++m)
    if (lane == m) lo = r[m];
#pragma unroll
  for (int m = 33; m < IH_MEMBERS; ++m)
    if (lane == m - 32) hi = r[m];
  T* o = out + static_cast<size_t>(b) * IH_MEMBERS;
  o[lane] = bad ? noval : lo;
  if (lane < IH_MEMBERS - 32) o[32 + lane] = bad ? noval : hi;
}

#define IH_PATH_WARP 0
#define IH_PATH_BLOCK 1   // the row staged in shared memory
#define IH_PATH_DEVICE 2  // the row read from device memory

template <typename T, int K>
static int launch_warp(const T* freq, const T* counts, const T* vmin,
                       const T* vmax, const T* pscale, const T* poffset,
                       T* out, int B, int N, T noval, cudaStream_t st) {
  ih_stats_warp_kernel<T, K><<<B, 32, 0, st>>>(
      freq, counts, vmin, vmax, pscale, poffset, out, N, noval);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* freq_, const void* counts_, const void* vmin_,
                  const void* vmax_, const void* pscale_, const void* poffset_,
                  void* out_, int B, int N, int path, int bins_lane,
                  double noval_, cudaStream_t st) {
  const T* freq = static_cast<const T*>(freq_);
  const T* counts = static_cast<const T*>(counts_);
  const T* vmin = static_cast<const T*>(vmin_);
  const T* vmax = static_cast<const T*>(vmax_);
  const T* pscale = static_cast<const T*>(pscale_);
  const T* poffset = static_cast<const T*>(poffset_);
  T* out = static_cast<T*>(out_);
  const T noval = static_cast<T>(noval_);
  if (path == IH_PATH_WARP) {
    switch (bins_lane) {
      case 1: return launch_warp<T, 1>(freq, counts, vmin, vmax, pscale, poffset, out, B, N, noval, st);
      case 2: return launch_warp<T, 2>(freq, counts, vmin, vmax, pscale, poffset, out, B, N, noval, st);
      case 4: return launch_warp<T, 4>(freq, counts, vmin, vmax, pscale, poffset, out, B, N, noval, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int staged = path == IH_PATH_BLOCK;
  const size_t smem = staged ? static_cast<size_t>(N) * sizeof(T) : 0;
  cudaError_t e = nyx_allow_smem(ih_stats_block_kernel<T>, smem,
                                 sizeof(IhShared<T>));
  if (e != cudaSuccess) return static_cast<int>(e);
  ih_stats_block_kernel<T><<<B, IH_BLOCK, smem, st>>>(
      freq, counts, vmin, vmax, pscale, poffset, out, N, staged, noval);
  return static_cast<int>(cudaGetLastError());
}

// freq: [B, N]; counts, vmin, vmax, pscale, poffset: [B], all of the input
// type; out: [B, 46] of the input type.  path: IH_PATH_WARP (a warp a ROI,
// bins_lane 1, 2 or 4, N <= 32 bins_lane),
// IH_PATH_BLOCK (a block a ROI, the row in shared memory) or IH_PATH_DEVICE
// (a block a ROI, the row read from device memory).
extern "C" int nyx_ih_stats(const void* freq, const void* counts,
                            const void* vmin, const void* vmax,
                            const void* pscale, const void* poffset, void* out,
                            int B, int N, int path, int bins_lane,
                            int is_f64, double noval, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(freq, counts, vmin, vmax, pscale, poffset, out, B, N,
                          path, bins_lane, noval, st);
  return launch<float>(freq, counts, vmin, vmax, pscale, poffset, out, B, N,
                       path, bins_lane, noval, st);
}
