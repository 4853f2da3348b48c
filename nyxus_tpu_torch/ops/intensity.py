"""First-order pixel-intensity features + per-ROI intensity histogram
(PyTorch port of nyxus_tpu/ops/intensity.py).

Batched implementation of the reference's ``PixelIntensityFeatures``
(reference: src/nyx/features/intensity.cpp:57-233) and its histogram engine
``TrivialHistogram`` (src/nyx/features/histogram.h:23-205,300-327).

Semantics reproduced:
* blank-ROI intercept (max == min): MEAN/MEDIAN/MIN/MAX = min, RANGE = 0, all
  other family members = the soft-NAN placeholder (intensity.cpp:60-98)
* percentiles via a 100-bin histogram with linear interpolation inside the
  landing bin, last matching bin winning (histogram.h:300-327)
* MEDIAN is the exact sorted-sample median, MODE is the smallest
  most-frequent value (histogram.h:353-395)
* ENTROPY/UNIFORMITY over an n-bin "custom" histogram, n = grey depth,
  entropy = -sum p*log2(p + 2.2e-16) (histogram.h:230-238)
* SKEWNESS = sqrt(n) m3 / m2^1.5 (n>3), KURTOSIS = n m4 / m2^2 (n>4),
  EXCESS = KURTOSIS - 3; 0 when m2 == 0 (moments.h:83-118)
* HYPERSKEWNESS = sum d^5 / (n sigma^5), HYPERFLATNESS = sum d^6 / (n sigma^6)
  with sigma the unbiased SD (intensity.cpp:210-224)
* ROBUST_MEAN / ROBUST_MAD over values in [P10, P90] (intensity.cpp:171-185)

Both histograms go through K1 (common.masked_bincount).
"""

from __future__ import annotations

import torch

from .common import last_true_value, masked_bincount, safe_div, take_per_row

PERCENTS = (0.01, 0.10, 0.25, 0.75, 0.90, 0.99)


def _sample_weights(valid, weights, dt):
    """Each entry's multiplicity: 1 at every finite value, or the given
    weights there; 0 at the padding."""
    if weights is None:
        return valid.to(dt)
    return torch.where(valid, weights.to(dt), 0.0)


def histogram_stats(values, n, vmin, vmax, nbins: int, weights=None):
    """Shared histogram statistics over sorted padded values.

    values: [B, A] ascending, padding = +inf; n: [B] areas;
    vmin, vmax: [B] per-ROI min/max.
    weights: optional [B, A] per-sample multiplicities (the oversized-ROI
    streaming path passes sorted UNIQUE values with their tile-accumulated
    counts; None = every finite sample counts once).
    Returns dict with p01..p99, median, mode, entropy, uniformity, iqr, rmad,
    robust_mean, hist ([B, nbins] custom-bin frequencies).
    """
    B, A = values.shape
    dt = values.dtype
    valid = torch.isfinite(values)
    w = _sample_weights(valid, weights, dt)
    rng = vmax - vmin
    k = w.sum(dim=1)
    ki = k.to(torch.int64)

    # --- 100-bin percentile histogram (histogram.h:50-62); the width is one
    # rounded division on every device: a CUDA tensor over a Python number
    # is multiplied by the number's rounded reciprocal (140 / 100 gives
    # 1.4000000000000001 there, 1.4 on the CPU), which moves the values on
    # a bin edge into the bin below
    binw = rng / torch.full_like(rng, 100.0)
    ridx = safe_div(values - vmin[:, None], binw[:, None])
    # padding rows give +inf here; their weight is 0, so any bin will do
    ridx = torch.where(valid, ridx, 0)
    idx100 = torch.clamp(ridx.to(torch.int32), 0, 99)   # bin 100 folds into 99
    bins100 = masked_bincount(idx100, w, 100)           # [B, 100]

    # --- interpolated percentiles (histogram.h:300-327)
    run = torch.cumsum(bins100, dim=1) - bins100        # runSum before bin i
    iarr = torch.arange(100, dtype=dt, device=values.device)
    left_edge = vmin[:, None] + binw[:, None] * iarr[None, :]
    pcts = {}
    for p in PERCENTS:
        cnt = k * p
        cond = (run <= cnt[:, None]) & (cnt[:, None] <= run + bins100)
        cand = (cnt[:, None] - run) * binw[:, None] / bins100 + left_edge
        pcts[p] = last_true_value(cond, cand, 0.0)

    # --- custom n-bin histogram (to_grayscale, helpers.h:337-345)
    pi = safe_div((values - vmin[:, None]) * nbins, rng[:, None])
    pi = torch.where(valid, pi, 0)
    idxc = torch.clamp(pi.to(torch.int32), 0, nbins - 1)  # fold top bin
    hist = masked_bincount(idxc, w, nbins)                 # [B, nbins]

    p_ = hist / torch.clamp(k[:, None], min=1)
    entropy = -(p_ * torch.log2(p_ + 2.2e-16)).sum(dim=1)
    uniformity = (p_ * p_).sum(dim=1)

    # --- exact median over the sorted sample (histogram.h:353-373)
    half = ki // 2
    if weights is None:
        v_hi = take_per_row(values, torch.clamp(half, 0, A - 1))
        v_lo = take_per_row(values, torch.clamp(half - 1, 0, A - 1))
    else:
        # expanded-sample order statistic: element k = first value whose
        # cumulative multiplicity exceeds k
        cumw = torch.cumsum(w, dim=1)

        def v_at(kk):
            pos = (cumw <= kk[:, None].to(dt)).sum(dim=1)
            return take_per_row(values, torch.clamp(pos, 0, A - 1))

        v_hi = v_at(half)
        v_lo = v_at(half - 1)
    median = torch.where(ki % 2 != 0, v_hi, (v_lo + v_hi) / 2.0)

    # --- mode: smallest most-frequent value (histogram.h:375-395)
    if weights is None:
        # run-length encode the sorted row; each element's run length is
        # (index of run end) - (index of run start) + 1
        idx = torch.arange(A, dtype=torch.int64,
                           device=values.device).expand(B, A)
        eq = values[:, 1:] == values[:, :-1]
        ones = torch.ones((B, 1), dtype=torch.bool, device=values.device)
        is_start = torch.cat([ones, ~eq], dim=1)
        is_end = torch.cat([~eq, ones], dim=1)
        run_start = torch.cummax(torch.where(is_start, idx, -1), dim=1).values
        run_end = torch.cummin(torch.where(is_end, idx, A).flip(1),
                               dim=1).values.flip(1)
        per_elem_count = torch.where(valid, run_end - run_start + 1, -1)
    else:
        # values are unique per row: multiplicity IS the weight
        per_elem_count = torch.where(valid, w, -1.0)
    first_max = torch.argmax(per_elem_count, dim=1)     # first idx of max count
    mode = take_per_row(values, first_max)

    # --- robust [p10, p90] statistics (intensity.cpp:171-185, histogram.h:86-106)
    in_1090 = valid & (values >= pcts[0.10][:, None]) \
        & (values <= pcts[0.90][:, None])
    w1090 = torch.where(in_1090, w, 0.0)
    pop1090 = w1090.sum(dim=1)
    mean1090 = safe_div((w1090 * torch.where(in_1090, values, 0)).sum(dim=1),
                        pop1090)
    rmad = safe_div(
        (w1090 * torch.where(in_1090, (values - mean1090[:, None]).abs(),
                             0)).sum(dim=1),
        pop1090)

    return dict(
        p01=pcts[0.01], p10=pcts[0.10], p25=pcts[0.25], p75=pcts[0.75],
        p90=pcts[0.90], p99=pcts[0.99], median=median, mode=mode,
        entropy=entropy, uniformity=uniformity,
        iqr=pcts[0.75] - pcts[0.25], rmad=rmad, robust_mean=mean1090,
        hist=hist,
    )


def pixel_intensity_features(values, n, vmin, vmax, slide_range, nbins: int,
                             noval: float, weights=None):
    """All PixelIntensityFeatures outputs.

    values: [B, A] sorted ascending (+inf padding); n: [B] int areas;
    vmin/vmax: [B]; slide_range: [B] slide-level intensity range
    (max_preroi - min_preroi) for COVERED_IMAGE_INTENSITY_RANGE.
    weights: optional [B, A] sample multiplicities (sorted-unique-value form
    used by the oversized-ROI streaming path); None = each sample once.
    Returns dict member-name -> [B] (HISTOGRAM -> [B, nbins]).
    """
    dt = values.dtype
    valid = torch.isfinite(values)
    wts = _sample_weights(valid, weights, dt)
    nf = n.to(dt)
    vz = torch.where(valid, values, 0)

    sum_v = (wts * vz).sum(dim=1)
    energy = (wts * vz * vz).sum(dim=1)
    mean = safe_div(sum_v, nf)
    d = torch.where(valid, values - mean[:, None], 0)
    mad = (wts * d.abs()).sum(dim=1) / torch.clamp(nf, min=1)
    m2 = (wts * d * d).sum(dim=1)
    d2 = d * d
    m5 = (wts * d2 * d2 * d).sum(dim=1)
    m6 = (wts * d2 * d2 * d2).sum(dim=1)

    var_u = torch.where(n > 1, m2 / torch.clamp(nf - 1, min=1), 0.0)
    var_b = torch.where(n > 1, m2 / torch.clamp(nf, min=1), 0.0)
    sd = torch.sqrt(var_u)
    sd_b = torch.sqrt(var_b)

    # powers via multiplies + sqrt (exactly-rounded ops)
    sd2 = sd * sd
    sd5 = sd2 * sd2 * sd
    sd6 = sd2 * sd2 * sd2
    # SKEWNESS/KURTOSIS: Moments4 accumulates with its OWN count and mean
    # (intensity.cpp:199-208, moments.h:83-118)
    kf = wts.sum(dim=1)
    mean_k = safe_div(sum_v, kf)
    dk = torch.where(valid, values - mean_k[:, None], 0)
    m2k = (wts * dk * dk).sum(dim=1)
    m3k = (wts * dk * dk * dk).sum(dim=1)
    m4k = (wts * (dk * dk) * (dk * dk)).sum(dim=1)
    m2k_15 = m2k * torch.sqrt(m2k)
    nzm = m2k != 0
    skew = torch.where((kf > 3) & nzm,
                       torch.sqrt(kf) * m3k / torch.where(nzm, m2k_15, 1), 0.0)
    kurt = torch.where((kf > 4) & nzm,
                       kf * m4k / torch.where(nzm, m2k * m2k, 1), 0.0)
    exkurt = torch.where((kf > 4) & nzm, kurt - 3.0, 0.0)
    hskew = safe_div(m5, nf * sd5)
    hflat = safe_div(m6, nf * sd6)

    hs = histogram_stats(values, n, vmin, vmax, nbins, weights)

    piu = (1.0 - safe_div(vmax - vmin, vmax + vmin)) * 100.0
    qcod = safe_div(hs["p75"] - hs["p25"], hs["p75"] + hs["p25"])
    medad = (wts * (vz - torch.where(valid, hs["median"][:, None], 0)).abs()
             ).sum(dim=1) / torch.clamp(nf, min=1)

    out = {
        "INTEGRATED_INTENSITY": sum_v,
        "MEAN": mean,
        "MEDIAN": hs["median"],
        "MIN": vmin,
        "MAX": vmax,
        "RANGE": vmax - vmin,
        "COVERED_IMAGE_INTENSITY_RANGE": safe_div(vmax - vmin, slide_range),
        "STANDARD_DEVIATION": sd,
        "STANDARD_DEVIATION_BIASED": sd_b,
        "VARIANCE": var_u,
        "VARIANCE_BIASED": var_b,
        "COV": safe_div(sd, mean),
        "STANDARD_ERROR": safe_div(sd, torch.sqrt(nf)),
        "SKEWNESS": skew,
        "KURTOSIS": kurt,
        "EXCESS_KURTOSIS": exkurt,
        "HYPERSKEWNESS": hskew,
        "HYPERFLATNESS": hflat,
        "MEAN_ABSOLUTE_DEVIATION": mad,
        "MEDIAN_ABSOLUTE_DEVIATION": medad,
        "ENERGY": energy,
        "ROOT_MEAN_SQUARED": torch.sqrt(safe_div(energy, nf)),
        "ENTROPY": hs["entropy"],
        "MODE": hs["mode"],
        "UNIFORMITY": hs["uniformity"],
        "UNIFORMITY_PIU": piu,
        "P01": hs["p01"], "P10": hs["p10"], "P25": hs["p25"],
        "P75": hs["p75"], "P90": hs["p90"], "P99": hs["p99"],
        "QCOD": qcod,
        "INTERQUARTILE_RANGE": hs["iqr"],
        "ROBUST_MEAN": hs["robust_mean"],
        "ROBUST_MEAN_ABSOLUTE_DEVIATION": hs["rmad"],
    }

    # blank-ROI intercept (intensity.cpp:60-98)
    blank = vmax == vmin
    keep_min = {"MEAN", "MEDIAN", "MIN", "MAX"}
    for key in list(out):
        if key in keep_min:
            out[key] = torch.where(blank, vmin, out[key])
        elif key == "RANGE":
            out[key] = torch.where(blank, 0.0, out[key])
        else:
            out[key] = torch.where(blank, noval, out[key])

    out["HISTOGRAM"] = torch.where(blank[:, None], 0.0, hs["hist"])
    return out
