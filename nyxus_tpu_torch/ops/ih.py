"""IBSI intensity-histogram (IH) family: 46 features from one N-bin
histogram per ROI (PyTorch port of nyxus_tpu/ops/ih.py).

Batched implementation of the reference's ``IntensityHistogramFeatures``
(reference: src/nyx/features/intensity_histogram.cpp:31-305).

Semantics reproduced exactly:
* N equal-width bins over the per-ROI [min, max]; bin index
  floor((v-min)/binW) clamped to [0, N-1] (v==max folds into the last bin)
* median = CENTER of the bin where the running count first exceeds
  floor(count/2) (bin-center median, not an interpolated quantile)
* p10/p25/p75/p90 = histogram quantiles interpolated inside the landing bin,
  with distinct lower-tail (p < 0.5) and upper-tail scans
  (intensity_histogram.cpp:69-103)
* "..._IDX" features are 1-based bin indices of the corresponding values
* robust statistics restricted to bins in [p10Index, p90Index]
* gradient g[0]=f[1]-f[0], g[N-1]=f[N-1]-f[N-2], else (f[i+1]-f[i-1])/2;
  extrema seeded from DBL_MIN / DBL_MAX (float32: its smallest normal and
  largest finite value) with first-strict-win indices (1-based), mirroring
  intensity_histogram.cpp:160-226
* pixel intensities are affinely mapped (poffset + pscale*inten) before
  binning so float/HU images report in the original intensity domain
  (float_domain_map, intensity_histogram.cpp:318-372); bin INDICES are
  invariant under that map, so the frequency table is built from raw values

The frequency table is K1 (common.masked_bincount); the statistics are K17
``ih_stats`` (csrc/ih_stats.cu, a warp a ROI up to 128 bins), with
``ih_features_from_freq_plain`` beside it, the only path for a tensor on the
CPU.  Both form every term in
the compute dtype as the JAX package does and accumulate the sums in
float64, so they differ only in the order of those sums.
"""

from __future__ import annotations

import torch

from .. import _build
from .common import (SMEM_MAX, _check_float, _kernel_device,
                     masked_bincount, safe_div, take_per_row)

_DBL_MIN = 2.2250738585072014e-308
_DBL_MAX = 1.7976931348623157e+308

# emission order = IntensityHistogramFeatures::featureset
# (intensity_histogram.h:27-80)
MEMBERS = (
    "IH_MEAN_VAL", "IH_VARIANCE_VAL", "IH_SKEWNESS_VAL",
    "IH_EXCESS_KURTOSIS_VAL", "IH_MEDIAN_VAL", "IH_MINIMUM_VAL",
    "IH_P10_VAL", "IH_P90_VAL", "IH_MAXIMUM_VAL", "IH_MODE_VAL",
    "IH_INTERQUANTILE_RANGE_VAL", "IH_RANGE_VAL",
    "IH_MEAN_ABSOLUTE_DEVIATION_VAL",
    "IH_ROBUST_MEAN_ABSOLUTE_DEVIATION_VAL",
    "IH_MEDIAN_ABSOLUTE_DEVIATION_VAL", "IH_COEFFICIENT_OF_VARIATION_VAL",
    "IH_QUANTILE_COEFFICIENT_OF_DISPERSION_VAL", "IH_ENTROPY_VAL",
    "IH_UNIFORMITY_VAL", "IH_ROBUST_MEAN_VAL",
    "IH_MEAN_IDX", "IH_VARIANCE_IDX", "IH_SKEWNESS_IDX",
    "IH_EXCESS_KURTOSIS_IDX", "IH_MEDIAN_IDX", "IH_MINIMUM_IDX",
    "IH_P10_IDX", "IH_P90_IDX", "IH_MAXIMUM_IDX", "IH_MODE_IDX",
    "IH_INTERQUANTILE_RANGE_IDX", "IH_RANGE_IDX",
    "IH_MEAN_ABSOLUTE_DEVIATION_IDX",
    "IH_ROBUST_MEAN_ABSOLUTE_DEVIATION_IDX",
    "IH_MEDIAN_ABSOLUTE_DEVIATION_IDX", "IH_COEFFICIENT_OF_VARIATION_IDX",
    "IH_QUANTILE_COEFFICIENT_OF_DISPERSION_IDX", "IH_ENTROPY_IDX",
    "IH_UNIFORMITY_IDX",
    "IH_MAX_GRADIENT", "IH_MAX_GRADIENT_IDX", "IH_MIN_GRADIENT",
    "IH_MIN_GRADIENT_IDX", "IH_ROBUST_MEAN_IDX", "IH_NUM_BINS",
    "IH_BIN_SIZE",
)
N_MEMBERS = len(MEMBERS)

# bytes of the row K17's block path stages in shared memory at most (the
# rest of a block's 227 KB holds its scan and reduction buffers)
_STAGE_MAX = SMEM_MAX - 8192
# K17's launch plan (ih_stats_plan): bins a row has at most on the warp
# path (32 lanes of up to 4 bins; at 8 bins a lane it ran slower than the
# block path: PERF.md); threads of the block path (csrc/ih_stats.cu
# IH_BLOCK)
IH_WARP_BINS = 128
IH_BLOCK = 256
_IH_PATHS = ("warp", "block", "device")


def _sum64(x):
    """Row sums of [B, N] accumulated in float64, returned in x's dtype."""
    return x.to(torch.float64).sum(dim=1).to(x.dtype)


def _first(cond):
    """Index of the first True of each row (0 when none)."""
    return torch.argmax(cond.to(torch.uint8), dim=1)


def _quantile_low(freq, cum, total, p, bin_min, binw):
    """Lower-tail interpolated histogram quantile (p < 0.5): the bins are
    scanned upward until cum/total >= p (intensity_histogram.cpp:72-88)."""
    N = freq.shape[1]
    cond = cum >= (total * p)[:, None]
    s = torch.where(cond.any(dim=1), _first(cond), N - 1)
    c_prev = torch.where(s > 0, take_per_row(cum, torch.clamp(s - 1, min=0)),
                         0.0)
    f_s = take_per_row(freq, s)
    p_prev = c_prev / total
    prop = f_s / total
    mn = bin_min + s.to(freq.dtype) * binw
    return mn + safe_div(p - p_prev, prop) * binw


def _quantile_high(freq, cum, total, p, bin_min, binw):
    """Upper-tail quantile (p >= 0.5): the bins are scanned downward until
    1 - cumFromTop/total <= p (intensity_histogram.cpp:89-103); the
    stopping bin is the largest i with C[i-1] <= p*total (C[-1] = 0)."""
    N = freq.shape[1]
    c_m1 = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)
    cond = c_m1 <= (total * p)[:, None]
    s = (N - 1) - _first(cond.flip(1))
    p_prev = take_per_row(cum, s) / total
    prop = take_per_row(freq, s) / total
    mx = bin_min + (s.to(freq.dtype) + 1.0) * binw
    return mx - safe_div(p_prev - p, prop) * binw


def ih_features_from_freq_plain(freq, counts, vmin, vmax, noval: float,
                                pscale, poffset):
    """Plain version of K17: the JAX package's formulation
    (nyxus_tpu/ops/ih.py:132) in PyTorch, each sum accumulated in float64.
    freq: [B, N] (N >= 2) exact bin counts; counts, vmin, vmax, pscale,
    poffset: [B].  Returns [B, 46] in MEMBERS order, ``noval`` on rows with
    max <= min or no pixels."""
    dt = freq.dtype
    dev = freq.device
    B, N = freq.shape
    total = counts.to(dt)
    bad = (vmax <= vmin) | (counts == 0)
    safe_total = torch.clamp(total, min=1.0)

    # reporting-domain bin geometry
    min_val = poffset + pscale * vmin
    max_val = poffset + pscale * vmax
    binw = (max_val - min_val) / N
    cum = torch.cumsum(freq.to(torch.float64), dim=1).to(dt)
    prob = freq / safe_total[:, None]

    ii = torch.arange(N, dtype=dt, device=dev)
    centers = min_val[:, None] + (ii[None, :] + 0.5) * binw[:, None]

    def index_of(v):
        k = torch.floor(safe_div(v - min_val, binw))
        return torch.clamp(k, 0, N - 1)

    # median: center of the bin where the running count first exceeds
    # count // 2
    half = torch.floor(total / 2.0)
    med_bin = _first(cum > half[:, None])
    median_v = take_per_row(centers, med_bin)
    median_i = index_of(median_v)

    p10_v = _quantile_low(freq, cum, safe_total, 0.10, min_val, binw)
    p25_v = _quantile_low(freq, cum, safe_total, 0.25, min_val, binw)
    p75_v = _quantile_high(freq, cum, safe_total, 0.75, min_val, binw)
    p90_v = _quantile_high(freq, cum, safe_total, 0.90, min_val, binw)
    p10_i, p25_i, p75_i, p90_i = (index_of(v) for v in (p10_v, p25_v, p75_v,
                                                          p90_v))
    min_i = index_of(min_val)
    max_i = index_of(max_val)

    # pass 1: means + robust means over [p10Index, p90Index]
    mean_v = _sum64(prob * centers)
    mean_i = _sum64(prob * ii[None, :])
    in_rob = (ii[None, :] >= p10_i[:, None]) & (ii[None, :] <= p90_i[:, None])
    robw = torch.where(in_rob, freq, 0.0)
    rob_cnt = _sum64(robw)
    rmean_v = safe_div(_sum64(robw * centers), rob_cnt)
    rmean_i = safe_div(_sum64(robw * ii[None, :]), rob_cnt)

    # pass 2: centred moments + deviations + entropy/uniformity (the powers
    # multiplied as jax.lax.integer_pow does: x (x x), (x x)(x x))
    dv = centers - mean_v[:, None]
    di = ii[None, :] - mean_i[:, None]
    var_v = _sum64(prob * dv * dv)
    var_i = _sum64(prob * di * di)
    skew_v = safe_div(_sum64(prob * (dv * (dv * dv))),
                       var_v * torch.sqrt(var_v))
    skew_i = safe_div(_sum64(prob * (di * (di * di))),
                       var_i * torch.sqrt(var_i))
    kurt_v = safe_div(_sum64(prob * ((dv * dv) * (dv * dv))),
                       var_v * var_v) - 3.0
    kurt_i = safe_div(_sum64(prob * ((di * di) * (di * di))),
                       var_i * var_i) - 3.0

    # mode: first bin with maximal frequency (strict-greater update)
    mode_bin = torch.argmax(freq, dim=1)
    mode_v = take_per_row(centers, mode_bin)

    mad_v = _sum64(prob * torch.abs(dv))
    mad_i = _sum64(prob * torch.abs(di))
    rmad_v = safe_div(_sum64(robw * torch.abs(centers - rmean_v[:, None])),
                       rob_cnt)
    rmad_i = safe_div(_sum64(robw * torch.abs(ii[None, :]
                                               - rmean_i[:, None])), rob_cnt)
    medad_v = _sum64(prob * torch.abs(centers - median_v[:, None]))
    medad_i = _sum64(prob * torch.abs(ii[None, :] - median_i[:, None]))

    pg = prob > 1e-7            # guard at intensity_histogram.cpp:201
    entropy = -_sum64(torch.where(
        pg, prob * torch.log2(torch.where(pg, prob, 1.0)), 0.0))
    uniformity = _sum64(prob * prob)

    cov_v = safe_div(torch.sqrt(var_v), mean_v)
    cov_i = safe_div(torch.sqrt(var_i), mean_i + 1.0)
    qcd_v = safe_div(p75_v - p25_v, p75_v + p25_v)
    qcd_i = safe_div(p75_i - p25_i, p75_i + p25_i + 2.0)

    # histogram gradient + seeded extrema (intensity_histogram.cpp:160-226)
    g_left = freq[:, 1] - freq[:, 0]
    g_right = freq[:, -1] - freq[:, -2]
    grad = torch.cat([g_left[:, None], (freq[:, 2:] - freq[:, :-2]) / 2.0,
                      g_right[:, None]], dim=1)
    fin = torch.finfo(dt)
    seed_min = _DBL_MIN if dt == torch.float64 else fin.tiny
    seed_max = _DBL_MAX if dt == torch.float64 else fin.max
    gmax = grad.amax(dim=1)
    gmax_i = torch.argmax(grad, dim=1).to(dt) + 1.0
    gmin = grad.amin(dim=1)
    gmin_i = torch.argmin(grad, dim=1).to(dt) + 1.0
    up = gmax > seed_min
    down = gmin < seed_max

    out = torch.stack((
        mean_v, var_v, skew_v, kurt_v, median_v, min_val, p10_v, p90_v,
        max_val, mode_v, p75_v - p25_v, max_val - min_val, mad_v, rmad_v,
        medad_v, cov_v, qcd_v, entropy, uniformity, rmean_v,
        mean_i + 1.0, var_i, skew_i, kurt_i,
        median_i + 1.0, min_i + 1.0, p10_i + 1.0, p90_i + 1.0, max_i + 1.0,
        mode_bin.to(dt) + 1.0, p75_i - p25_i, max_i - min_i,
        mad_i, rmad_i, medad_i, cov_i, qcd_i, entropy, uniformity,
        torch.where(up, gmax, seed_min), torch.where(up, gmax_i, 0.0),
        torch.where(down, gmin, seed_max), torch.where(down, gmin_i, 0.0),
        rmean_i, torch.full((B,), float(N), dtype=dt, device=dev), binw,
    ), dim=1)
    return torch.where(bad[:, None], noval, out)


def ih_bins_a_lane(N: int) -> int:
    """Bins a lane of K17's warp path for rows of N <= IH_WARP_BINS bins:
    the least power of two that covers the row in 32 lanes (1, 2 or 4)."""
    K = 1
    while 32 * K < N:
        K *= 2
    return K


def ih_stats_plan(N: int, esz: int):
    """(path, bins a lane or thread) of K17's launch for rows of N bins of
    esz bytes.  "warp" (N <= IH_WARP_BINS): a block of one warp a ROI, each
    lane holding ih_bins_a_lane(N) contiguous bins (more warps a block
    measured no faster at 300 and 1056 rows: PERF.md).  Past IH_WARP_BINS a
    block a ROI of IH_BLOCK threads, ceil(N / IH_BLOCK) bins a thread:
    "block" with the row staged in shared memory (N esz <= _STAGE_MAX),
    else "device"."""
    if N <= IH_WARP_BINS:
        return "warp", ih_bins_a_lane(N)
    return ("block" if N * esz <= _STAGE_MAX else "device"), -(-N // IH_BLOCK)


def ih_stats(freq, counts, vmin, vmax, noval: float, pscale, poffset):
    """K17 ih_stats (csrc/ih_stats.cu), replacing
    nyxus_tpu/ops/ih.py:132 ih_features_from_freq (with its quantile scans
    :62,80).  Arguments and result as ih_features_from_freq_plain.  One
    launch (``ih_stats_plan``): up to 128 bins a warp a ROI with the row
    in registers and no block barrier -- a warp scan
    of the lanes' counts, the landing bins of the median and the four
    quantiles by ballots, the mode and the gradient extrema by shuffle
    reductions, then two register passes of float64 sums reduced by a
    reduce-scatter and the 46 members stored as one row; beyond 128 bins
    a block a ROI, the row in shared or device memory.  Bin indices equal
    the plain version's; the values differ by the order of the float64
    sums only.  Bound on the card: the ~60 operations of a bin, and the
    launch and the warp's chain of steps at small N."""
    if not _kernel_device(freq, "ih_stats"):
        return ih_features_from_freq_plain(freq, counts, vmin, vmax, noval,
                                           pscale, poffset)
    _check_float(freq, "ih_stats")
    if freq.dim() != 2 or freq.shape[1] < 2:
        raise ValueError("ih_stats: freq must be [B, N] with N >= 2, got %s"
                         % (tuple(freq.shape),))
    B, N = freq.shape
    dt = freq.dtype
    rows = []
    for name, t in (("counts", counts), ("vmin", vmin), ("vmax", vmax),
                    ("pscale", pscale), ("poffset", poffset)):
        if tuple(t.shape) != (B,) or t.device != freq.device:
            raise ValueError("ih_stats: %s %s must be [%d] on %s"
                             % (name, tuple(t.shape), B, freq.device))
        rows.append(t.to(dt).contiguous())
    freq = freq.contiguous()
    out = torch.empty((B, N_MEMBERS), dtype=dt, device=freq.device)
    if B == 0:
        return out
    path, bins_lane = ih_stats_plan(N, freq.element_size())
    code = _build.lib().nyx_ih_stats(
        freq.data_ptr(), *(r.data_ptr() for r in rows), out.data_ptr(),
        B, N, _IH_PATHS.index(path), bins_lane,
        int(dt == torch.float64), float(noval),
        _build.stream_of(freq, "ih_stats"))
    _build.check("ih_stats", code)
    ih_stats.launches += 1
    return out


ih_stats.launches = 0


def ih_features_from_freq(freq, counts, vmin, vmax, nbins: int, noval: float,
                          pscale=None, poffset=None):
    """IH stats from a precomputed N-bin frequency table (the oversized-ROI
    streaming path accumulates ``freq`` tile by tile; reference analog:
    IntensityHistogramFeatures::osized_calculate).  Returns {member: [B]};
    K17 on a CUDA tensor, the plain version on the CPU."""
    dt = freq.dtype
    B, N = freq.shape
    if N < 2:
        nv = torch.full((B,), noval, dtype=dt, device=freq.device)
        return {m: nv for m in MEMBERS}
    if pscale is None:
        pscale = torch.ones((B,), dtype=dt, device=freq.device)
    if poffset is None:
        poffset = torch.zeros((B,), dtype=dt, device=freq.device)
    out = ih_stats(freq, counts, vmin, vmax, noval, pscale, poffset)
    return {m: out[:, k] for k, m in enumerate(MEMBERS)}


def ih_freq(values, vmin, vmax, nbins: int):
    """[B, N] frequency table of N equal-width bins over each ROI's raw
    [vmin, vmax] (K1), in values' dtype.  values: [B, A] raw pixel
    intensities, +inf padding.

    The bin index is computed in float64 whatever the compute dtype: the
    raw intensities and their range are integers, exact in float32 too, but
    float32's rounding of N / range moves a value that sits on a bin edge
    (25 * 64 / 100) into the bin below, which float64 (the reference's
    double) does not."""
    N = int(nbins)
    valid = torch.isfinite(values)
    x = values.to(torch.float64)
    lo = vmin.to(torch.float64)
    hi = vmax.to(torch.float64)
    raw_rng = torch.where(hi > lo, hi - lo, 1.0)
    # N / raw_rng as one rounded division (a Python number over a tensor
    # would be N times the rounded reciprocal in PyTorch)
    scale = torch.full_like(raw_rng, float(N)) / raw_rng
    idx = torch.floor((x - lo[:, None]) * scale[:, None])
    idx = torch.clamp(idx, 0, N - 1).to(torch.int32)
    return masked_bincount(idx, valid.to(values.dtype), N)


def ih_features(values, counts, vmin, vmax, nbins: int, noval: float,
                pscale=None, poffset=None):
    """All 46 IH features.

    values: [B, A] raw stored pixel intensities, +inf padding (any order);
    counts: [B] pixel counts; vmin/vmax: [B] raw per-ROI min/max;
    pscale/poffset: [B] affine map into the reporting intensity domain
    (1.0 / 0.0 for integer images).  Returns {member: [B]}.  Degenerate
    ROIs (max <= min or empty) emit ``noval`` for every member, and so
    does every ROI when nbins < 2."""
    if int(nbins) < 2:
        nv = torch.full((values.shape[0],), noval, dtype=values.dtype,
                        device=values.device)
        return {m: nv for m in MEMBERS}
    freq = ih_freq(values, vmin, vmax, nbins)
    return ih_features_from_freq(freq, counts, vmin, vmax, nbins, noval,
                                 pscale, poffset)
