# Ported from nyxus_tpu/pipeline/oversized.py; pinned by tests/test_torch_tables.py.
"""Oversized-ROI streaming path (PyTorch port of
nyxus_tpu/pipeline/oversized.py; the reference's "nontrivial" phase 3).

ROIs whose padded AABB crop exceeds the RAM/HBM budget never materialize as a
dense matrix.  Instead one tile-streamed pass over the ROI's AABB accumulates
sufficient statistics (reference analog: per-feature ``osized_calculate``
over an ``OutOfRamPixelCloud``, phase3.cpp:24-127, image_matrix_nontriv.h):

* an exact sparse value histogram (unique intensity -> count) -- every
  first-order intensity and IBSI-IH feature is a functional of it, so those
  families reuse the SAME feature functions via their weighted-sample form
* raw geometric moment sums ``S[p][q] = sum w x^p y^q`` (AABB-local, orders
  0..3) for shape and intensity weightings -- computed per tile as two tiny
  matmuls ``Y (4xH) @ M (HxW) @ X^T (Wx4)``; raw/central/normalized/Hu
  moments, basic morphology, and ellipse fit all derive from them
* an optional second pass for centroid-dependent non-polynomial sums
  (distance-to-centroid mean/std for COMPACTNESS)

Texture matrices (all 7 families) stream through the tiled accumulators in
``oversized_tex.py``; the streamed byte-mask contour trace
(``pipeline/contour.py oversized_contour``) feeds hull/caliper/circle/
geodetic/neighbor geometry.  Families listed in ``STREAMABLE`` are assigned
for oversized ROIs; the remainder stay unassigned (-0.0).

The accumulators are numpy, as in the JAX package.  Their finish stages
(the intensity, IH and texture statistics of the accumulated histograms,
matrices and zone lists) run in float64 on the runner's torch device,
whatever the request's precision, through the port's feature functions:
K1 (``masked_bincount``) forms the weighted intensity histograms and K17
(``ih_stats``) the IH statistics on a CUDA device, their plain versions on
the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# cap on tracked unique intensity values; beyond it (float slides) the
# histogram degrades to 2^16 equal bins over [vmin, vmax]
_MAX_UNIQUES = 1 << 20
_FALLBACK_BINS = 1 << 16


def is_oversized(rec, budget_bytes: int, bytes_per_px: int = 16) -> bool:
    """True when the ROI's padded crop cannot fit the batch budget
    (reference RAM gate: workflow_2d_segmented.cpp:124-139)."""
    from . import batching
    if rec.height > batching._LADDER[-1] or rec.width > batching._LADDER[-1]:
        return True
    hb, wb = batching.bucket_shape(rec.height, rec.width)
    return hb * wb * bytes_per_px > budget_bytes


class OversizedAccums:
    __slots__ = ("vals", "cnts", "exact", "S_shape", "S_int", "area",
                 "vmin", "vmax", "S_wshape", "S_wint")

    def __init__(self):
        self.vals = np.zeros(0, np.float64)   # unique intensities (sorted)
        self.cnts = np.zeros(0, np.float64)
        self.exact = True
        self.S_shape = np.zeros((4, 4), np.float64)  # sum x^p y^q over mask
        self.S_int = np.zeros((4, 4), np.float64)    # sum I x^p y^q
        self.area = 0
        self.vmin = np.inf
        self.vmax = -np.inf
        # distance-to-contour weighted sums (reference weighted moments,
        # 2d_geomoments.h:113-261): w = log(sqrt(min_d2) + eps) per pixel;
        # None until a streamed contour is supplied to ``accumulate``
        self.S_wshape = None    # sum w x^p y^q
        self.S_wint = None      # sum I w x^p y^q


def _merge_hist(acc: OversizedAccums, bu: np.ndarray, bc: np.ndarray):
    allv = np.concatenate([acc.vals, bu])
    allc = np.concatenate([acc.cnts, bc])
    vals, inv = np.unique(allv, return_inverse=True)
    cnts = np.zeros(vals.size, np.float64)
    np.add.at(cnts, inv, allc)
    acc.vals, acc.cnts = vals, cnts


def _to_binned(acc: OversizedAccums, vmin: float, vmax: float):
    """Degrade the exact histogram to fixed equal-width bins (bin centers
    stand in for values)."""
    rng = max(vmax - vmin, 1e-300)
    idx = np.clip(((acc.vals - vmin) * (_FALLBACK_BINS / rng)).astype(np.int64),
                  0, _FALLBACK_BINS - 1)
    cnts = np.zeros(_FALLBACK_BINS, np.float64)
    np.add.at(cnts, idx, acc.cnts)
    centers = vmin + (np.arange(_FALLBACK_BINS) + 0.5) * (rng / _FALLBACK_BINS)
    keep = cnts > 0
    acc.vals, acc.cnts, acc.exact = centers[keep], cnts[keep], False


def accumulate(rec, source, block: int = 2048,
               contour=None) -> OversizedAccums:
    """One streamed pass over the ROI's AABB.

    ``contour``: optional [K, 3] int64 merged streamed contour in +1-shifted
    local coordinates (pipeline/contour.py oversized_contour).  When present
    the distance-to-contour WEIGHTED moment sums are accumulated too, using
    the reference's approximate ordered-contour distance search
    (2d_geomoments.h:113-261, pixel.cpp:36-71) -- same convention as the
    trivial path's logw plane (runner.py)."""
    acc = OversizedAccums()
    p4 = np.arange(4, dtype=np.float64)
    ccx = ccy = None
    if contour is not None and len(contour):
        from ..ops.moments import WEIGHTING_EPSILON
        from .. import native
        ccx = np.ascontiguousarray(contour[:, 0], np.float64)
        ccy = np.ascontiguousarray(contour[:, 1], np.float64)
        acc.S_wshape = np.zeros((4, 4), np.float64)
        acc.S_wint = np.zeros((4, 4), np.float64)
    for by in range(rec.y0, rec.y1 + 1, block):
        bh = min(block, rec.y1 + 1 - by)
        for bx in range(rec.x0, rec.x1 + 1, block):
            bw = min(block, rec.x1 + 1 - bx)
            ii, ll = source.read_pair(by, bx, bh, bw)
            m = ll == rec.label
            if not m.any():
                continue
            vals = ii[m]
            acc.area += vals.size
            acc.vmin = min(acc.vmin, vals.min())
            acc.vmax = max(acc.vmax, vals.max())
            bu, bc = np.unique(vals, return_counts=True)
            _merge_hist(acc, bu, bc.astype(np.float64))
            if acc.exact and acc.vals.size > _MAX_UNIQUES:
                _to_binned(acc, rec.vmin, rec.vmax)
            # moment sums: Y^T M X with Vandermonde factors in local coords
            ylocal = (by - rec.y0) + np.arange(bh, dtype=np.float64)
            xlocal = (bx - rec.x0) + np.arange(bw, dtype=np.float64)
            Y = ylocal[None, :] ** p4[:, None]           # [4, bh]
            X = xlocal[None, :] ** p4[:, None]           # [4, bw]
            Ms = m.astype(np.float64)
            Mi = np.where(m, ii, 0.0)
            # S[p, q] += sum_y sum_x w[y,x] x^p y^q
            acc.S_shape += (Y @ Ms @ X.T).T
            acc.S_int += (Y @ Mi @ X.T).T
            if ccx is not None:
                ys_b, xs_b = np.nonzero(m)
                mind2, _ = native.contour_sqdist_approx(
                    (xs_b + (bx - rec.x0)).astype(np.float64),
                    (ys_b + (by - rec.y0)).astype(np.float64), ccx, ccy)
                lw = np.zeros((bh, bw))
                lw[ys_b, xs_b] = np.log(np.sqrt(mind2) + WEIGHTING_EPSILON)
                acc.S_wshape += (Y @ lw @ X.T).T
                acc.S_wint += (Y @ (lw * Mi) @ X.T).T
    return acc


def compactness_pass(rec, source, cx: float, cy: float,
                     block: int = 2048):
    """Second pass: mean/std of pixel distance to the GLOBAL centroid
    (basic_morphology.cpp Moments2 over dist)."""
    s1 = s2 = 0.0
    n = 0
    for by in range(rec.y0, rec.y1 + 1, block):
        bh = min(block, rec.y1 + 1 - by)
        for bx in range(rec.x0, rec.x1 + 1, block):
            bw = min(block, rec.x1 + 1 - bx)
            _, ll = source.read_pair(by, bx, bh, bw)
            m = ll == rec.label
            if not m.any():
                continue
            ys, xs = np.nonzero(m)
            d = np.hypot(xs + bx - cx, ys + by - cy)
            s1 += d.sum()
            s2 += (d * d).sum()
            n += d.size
    if n == 0:
        return 0.0
    mean = s1 / n
    m2 = s2 - n * mean * mean
    std = math.sqrt(m2 / (n - 1)) if n > 2 else 0.0
    return std / n


# ---------------------------------------------------------------------------
# feature synthesis from the accumulators

# the finish stages' dtype: the accumulators are float64 sums and counts,
# and their matrices are kilobytes, so the statistics keep float64 on any
# device
FINISH_DTYPE = torch.float64


def _dev(x, device, dtype=FINISH_DTYPE):
    """A numpy array or number as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _host(out):
    """{member: [1, ...] tensor} -> {member: numpy value of row 0}, in one
    device-to-host copy."""
    keys = list(out)
    flat = [out[k].reshape(out[k].shape[0], -1)[:1].to(FINISH_DTYPE)
            for k in keys]
    host = torch.cat(flat, dim=1).cpu().numpy()[0] if flat else ()
    res, off = {}, 0
    for k, f in zip(keys, flat):
        w = f.shape[1]
        v = host[off:off + w]
        res[k] = v[0] if out[k].dim() == 1 else v.reshape(out[k].shape[1:])
        off += w
    return res


def _pad_pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


def intensity_members(acc: OversizedAccums, slide_min, slide_max, cfg,
                      device="cpu"):
    """PixelIntensityFeatures via the weighted form of the SAME function
    (its histograms through K1 on a CUDA device)."""
    from ..ops.intensity import pixel_intensity_features

    U = _pad_pow2(acc.vals.size)
    vals = np.full((1, U), np.inf)
    wts = np.zeros((1, U))
    vals[0, :acc.vals.size] = acc.vals
    wts[0, :acc.vals.size] = acc.cnts
    nbins = int(cfg.coarse_gray_depth)
    out = pixel_intensity_features(
        _dev(vals, device), _dev([acc.area], device, torch.int64),
        _dev([acc.vmin], device), _dev([acc.vmax], device),
        _dev([float(slide_max - slide_min)], device), nbins, cfg.noval,
        weights=_dev(wts, device))
    return _host(out)


def ih_members(acc: OversizedAccums, cfg, slide_min=0.0, hu_offset=0.0,
               device="cpu"):
    """IntensityHistogramFeatures from the streamed histogram (K17 on a
    CUDA device)."""
    from ..ops.ih import MEMBERS, ih_features_from_freq

    if not cfg.ibsi:  # IBSI gate mirrors the trivial path (registry._ih_family)
        return {m: cfg.noval for m in MEMBERS}
    # HU mode undoes the load-time slope-1 offset: the ORIGINAL pre-shift
    # slide min (intensity_histogram.cpp:341)
    pscale = 1.0
    poffset = hu_offset if cfg.preserve_hu else 0.0
    N = int(cfg.coarse_gray_depth)
    rng = acc.vmax - acc.vmin if acc.vmax > acc.vmin else 1.0
    idx = np.clip(np.floor((acc.vals - acc.vmin) * (N / rng)),
                  0, N - 1).astype(np.int64)
    freq = np.zeros((1, N))
    np.add.at(freq[0], idx, acc.cnts)
    out = ih_features_from_freq(
        _dev(freq, device), _dev([acc.area], device, torch.int64),
        _dev([acc.vmin], device), _dev([acc.vmax], device), N, cfg.noval,
        _dev([pscale], device), _dev([poffset], device))
    return {k: float(v) for k, v in _host(out).items()}


def _central_from_raw(S: np.ndarray):
    """C[p][q] from raw local sums via the binomial shift identity."""
    m00 = S[0, 0]
    if m00 <= 0:
        return np.zeros((4, 4)), 0.0, 0.0
    ox, oy = S[1, 0] / m00, S[0, 1] / m00
    C = np.zeros((4, 4))
    for p in range(4):
        for q in range(4):
            v = 0.0
            for i in range(p + 1):
                for j in range(q + 1):
                    v += (math.comb(p, i) * math.comb(q, j) *
                          (-ox) ** (p - i) * (-oy) ** (q - j) * S[i, j])
            C[p, q] = v
    return C, ox, oy


def _central_any_sign(S: np.ndarray):
    """C[p][q] via the binomial shift identity about the (possibly
    negative-mass) centroid S10/S00, S01/S00 -- weighted sums can carry
    negative total mass (log weights)."""
    m00 = S[0, 0]
    if m00 == 0:
        ox = oy = 0.0
    else:
        ox, oy = S[1, 0] / m00, S[0, 1] / m00
    C = np.zeros((4, 4))
    for p in range(4):
        for q in range(4):
            v = 0.0
            for i in range(p + 1):
                for j in range(q + 1):
                    v += (math.comb(p, i) * math.comb(q, j) *
                          (-ox) ** (p - i) * (-oy) ** (q - j) * S[i, j])
            C[p, q] = v
    return C


def _signed_pow_np(base: float, k: float) -> float:
    """std::pow semantics (mirrors ops/moments._signed_pow): negative base
    with non-integer exponent -> NaN."""
    if base < 0 and k != float(int(k)):
        return float("nan")
    ab = abs(base) ** k
    if base < 0 and int(k) % 2 == 1:
        return -ab
    return ab


def moments_members(acc: OversizedAccums):
    """IMOM_*/SMOM_* (raw/central/normalized/Hu) from streamed sums,
    including the distance-to-contour weighted variants when ``accumulate``
    ran with a contour (2d_geomoments_basic_nt.cpp streams these for
    nontrivial ROIs in the reference)."""
    from ..ops import moments as mm

    out = {}
    for prefix, S in (("IMOM", acc.S_int), ("SMOM", acc.S_shape)):
        m00 = S[0, 0]
        C, _, _ = _central_from_raw(S)
        for p, q in mm.RAW_PQ:
            out["%s_RM_%d%d" % (prefix, p, q)] = S[p, q]
        for p, q in mm.CENTRAL_PQ:
            out["%s_CM_%d%d" % (prefix, p, q)] = C[p, q]
        denom = m00 if m00 > 0 else 1.0
        for p, q in mm.NORM_RAW_PQ:
            k = (p + q) / 2.0 + 1.0
            out["%s_NRM_%d%d" % (prefix, p, q)] = (
                S[p, q] / denom ** k if m00 > 0 else 0.0)
        nu = {}
        for p, q in mm.NORM_CENTRAL_PQ:
            k = (p + q) / 2.0 + 1.0
            nu[(p, q)] = C[p, q] / denom ** k if m00 > 0 else 0.0
            out["%s_NCM_%d%d" % (prefix, p, q)] = nu[(p, q)]
        hu = mm._hu({k: np.asarray([v]) for k, v in nu.items()})
        for i in range(7):
            out["%s_HU%d" % (prefix, i + 1)] = float(np.asarray(hu[i])[0])

    # weighted variants (w = log(dist_to_contour + eps))
    if acc.S_wint is None:
        return out
    for prefix, WS in (("IMOM", acc.S_wint), ("SMOM", acc.S_wshape)):
        wm00 = WS[0, 0]
        for p, q in mm.W_RAW_PQ:
            out["%s_WRM_%d%d" % (prefix, p, q)] = WS[p, q]
        WC = _central_any_sign(WS)
        wnu = {}
        for p, q in mm.W_CENTRAL_PQ:
            out["%s_WCM_%d%d" % (prefix, p, q)] = WC[p, q]
            k = (p + q) / 2.0 + 1.0
            wnu[(p, q)] = WC[p, q] / _signed_pow_np(wm00, k)
            out["%s_WNCM_%d%d" % (prefix, p, q)] = wnu[(p, q)]
        whu = mm._hu({k: np.asarray([v]) for k, v in wnu.items()})
        for i in range(7):
            out["%s_WHU%d" % (prefix, i + 1)] = float(np.asarray(whu[i])[0])
    return out


def basic_morphology_members(rec, acc: OversizedAccums, compactness: float,
                             cfg=None):
    S, Si = acc.S_shape, acc.S_int
    n = float(acc.area)
    cx = S[1, 0] / n + rec.x0
    cy = S[0, 1] / n + rec.y0
    mass = Si[0, 0]
    if mass > 0:
        wcx = Si[1, 0] / mass + rec.x0
        wcy = Si[0, 1] / mass + rec.y0
        mass_disp = math.hypot(wcx - cx, wcy - cy)
    else:
        wcx = wcy = 0.0
        mass_disp = math.hypot(cx, cy)
    h, w = float(rec.height), float(rec.width)
    return {
        "AREA_PIXELS_COUNT": n,
        "AREA_UM2": -0.0,   # reference leaves XYRES unset (ops/morphology.py)
        "DIAMETER_EQUAL_AREA": 2.0 * math.sqrt(n / math.pi),
        "BBOX_XMIN": float(rec.x0),
        "BBOX_YMIN": float(rec.y0),
        "BBOX_WIDTH": w,
        "BBOX_HEIGHT": h,
        "CENTROID_X": cx,
        "CENTROID_Y": cy,
        "COMPACTNESS": compactness,
        "WEIGHTED_CENTROID_X": wcx,
        "WEIGHTED_CENTROID_Y": wcy,
        "MASS_DISPLACEMENT": mass_disp,
        "EXTENT": n / (h * w),
        "ASPECT_RATIO": w / h,
    }


def ellipse_members(acc: OversizedAccums):
    """EllipseFittingFeature from second central moments
    (ellipse_fitting.cpp:20-65)."""
    n = float(acc.area)
    C, _, _ = _central_from_raw(acc.S_shape)
    uxx = C[2, 0] / n + 1.0 / 12.0
    uyy = C[0, 2] / n + 1.0 / 12.0
    uxy = C[1, 1] / n
    common = math.sqrt((uxx - uyy) ** 2 + 4.0 * uxy * uxy)
    major = 2.0 * math.sqrt(2.0) * math.sqrt(uxx + uyy + common)
    minor = 2.0 * math.sqrt(2.0) * math.sqrt(max(uxx + uyy - common, 0.0))
    ecc = math.sqrt(max(1.0 - (minor * minor) / (major * major), 0.0))
    if uxy == 0.0:
        orient = 0.0 if uxx >= uyy else 90.0
    elif uyy > uxx:
        num = uyy - uxx + math.sqrt((uyy - uxx) ** 2 + 4 * uxy * uxy)
        orient = 180.0 / math.pi * math.atan(num / (2 * uxy))
    else:
        den = uxx - uyy + math.sqrt((uxx - uyy) ** 2 + 4 * uxy * uxy)
        orient = 180.0 / math.pi * math.atan(2 * uxy / den)
    return {
        "MAJOR_AXIS_LENGTH": major,
        "MINOR_AXIS_LENGTH": minor,
        "ECCENTRICITY": ecc,
        "ELONGATION": minor / major,
        "ORIENTATION": orient,
        "ROUNDNESS": (4.0 * n) / (math.pi * major * major),
    }


# texture families served by the tile-streamed matrix accumulators
# (pipeline/oversized_tex.py; reference analog: per-feature osized_calculate
# over OutOfRamPixelCloud, phase3.cpp:94-114)
TEX_FAMILIES = ("GLCMFeature", "GLRLMFeature", "GLSZMFeature", "GLDZMFeature",
                "GLDMFeature", "NGLDMfeature", "NGTDMFeature")


def _pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


# above this pixel count the one-shot GLDZM level plane (int32 + a few
# transient int32 distance planes) would strain host RAM; fall back to the
# two-half-pass streamed union-find
_GLDZM_PLANE_CAP = 1 << 27


def _agg_zones(zlev, zval, w):
    """Collapse zone lists to unique (level, value) pairs with summed
    weights before shipping to the device kernels: a noisy giant ROI has
    millions of zones but only ~levels x sizes distinct pairs, and the
    jitted zone kernels are weight-aware."""
    comp = (zlev[0].astype(np.int64) << np.int64(42)) + \
        zval[0].astype(np.int64)
    u, inv = np.unique(comp, return_inverse=True)
    ws = np.zeros(u.shape[0], np.float64)
    np.add.at(ws, inv, w[0])
    return ((u >> np.int64(42)).astype(np.float64)[None],
            (u & ((np.int64(1) << 42) - 1)).astype(np.float64)[None],
            ws[None])


def texture_members(rec, source, cfg, families, slide_max, block: int = 2048,
                    device="cpu"):
    """Streamed texture pass: one top-down strip sweep feeding all wanted
    accumulators (+ one bottom-up sweep for GLDZM), then the SAME feature
    functions as the trivial path, in float64 on ``device``.  Returns
    {family: {member: value}}."""
    from . import oversized_tex as ot

    want = [f for f in families if f in TEX_FAMILIES]
    if not want:
        return {}

    W = rec.width
    H = rec.height
    dt = FINISH_DTYPE

    if cfg.ibsi:
        ceil = max(int(slide_max), 2)
        ng_ibsi = 1 << (ceil - 1).bit_length()

    def setup(family):
        """(greyinfo, ng) mirroring registry._texture_setup."""
        if cfg.ibsi:
            return 0, ng_ibsi
        g = cfg.texture_greydepth(family)
        return g, abs(g)

    accs = {}
    greyinfos = {}
    if "GLCMFeature" in want:
        g, ng = setup("glcm")
        greyinfos["glcm"] = g
        accs["glcm"] = ot.GlcmAccum(cfg.glcm_angles, cfg.glcm_offset, ng)
    if "GLRLMFeature" in want:
        g, ng = setup("glrlm")
        greyinfos["glrlm"] = g
        accs["glrlm"] = ot.RunAccum(ng, W)
    if "GLSZMFeature" in want:
        g, ng = setup("glszm")
        greyinfos["glszm"] = g
        accs["glszm"] = ot.SzAccum(W)
    gldzm_plane = None
    if "GLDZMFeature" in want:
        g, ng = setup("gldzm")
        greyinfos["gldzm"] = g
        if H * W <= _GLDZM_PLANE_CAP:
            # one-shot vectorized zone labeling over an int32 level plane
            # (16x+ cheaper than the dense compute crop; same budget
            # rationale as the streamed contour's byte mask)
            gldzm_plane = np.empty((H, W), np.int32)
        else:
            accs["gldzm"] = ot.DzAccum(W)
            accs["gldzm_b"] = ot.DzAccum(W)
    need_ngtdm = "NGTDMFeature" in want
    need_gldm = "GLDMFeature" in want
    need_ngldm = "NGLDMfeature" in want
    if need_ngtdm or need_gldm or need_ngldm:
        # NGTDM and GLDM share greyinfo semantics; a per-family override that
        # differs would need separate accumulators -- use each family's own
        g_ngtdm, ng_ngtdm = setup("ngtdm") if need_ngtdm else (0, 1)
        g_gldm, ng_gldm = setup("gldm") if need_gldm else (0, 1)
        if need_ngtdm:
            greyinfos["ngtdm"] = g_ngtdm
        if need_gldm:
            greyinfos["gldm"] = g_gldm
        if need_ngtdm and need_gldm and g_ngtdm != g_gldm:
            raise NotImplementedError(
                "oversized path: differing ngtdm/gldm grey depths")
        ng_shared = max(ng_ngtdm, ng_gldm)
        nb_ngldm = ng_ibsi if cfg.ibsi else abs(cfg.coarse_gray_depth)
        accs["neigh"] = ot.NeighborhoodAccum(ng_shared, nb_ngldm, need_ngtdm,
                                             need_gldm, need_ngldm)

    n_nonzero = 0           # Np: original-intensity-nonzero pixel count
    maxlev_ngtdm = 0

    def levels_for(orig, g):
        return ot.bin_levels_np(orig, rec.vmin, rec.vmax, g)

    def sweep(top_down: bool):
        nonlocal n_nonzero, maxlev_ngtdm
        lev_cache_keys = sorted(set(greyinfos.values()))
        y_blocks = list(range(rec.y0, rec.y1 + 1, block))
        if not top_down:
            y_blocks = y_blocks[::-1]
        for by in y_blocks:
            bh = min(block, rec.y1 + 1 - by)
            ii, ll = source.read_pair(by, rec.x0, bh, W)
            m = ll == rec.label
            orig = np.where(m, ii, 0.0)
            levs = {g: levels_for(orig, g) for g in lev_cache_keys}
            if not top_down:
                # GLDZM backward half-pass only
                g = greyinfos["gldzm"]
                lv = levs[g]
                valid = np.ones(W, bool) if g > 0 else None
                for r in range(bh - 1, -1, -1):
                    vrow = valid if valid is not None else (lv[r] > 0)
                    accs["gldzm_b"].feed_row(lv[r], vrow, by + r - rec.y0)
                continue

            n_nonzero += int((orig > 0).sum())
            if gldzm_plane is not None:
                g = greyinfos["gldzm"]
                lvb = levs[g]
                vb = np.ones_like(lvb, bool) if g > 0 else lvb > 0
                gldzm_plane[by - rec.y0: by - rec.y0 + bh] = \
                    np.where(vb, lvb, -1).astype(np.int32)
            if "glcm" in accs:
                accs["glcm"].feed(orig, levs[greyinfos["glcm"]])
            if need_ngldm:
                if cfg.ibsi:
                    nglev = np.where(m, ii.astype(np.int64), -1)
                else:
                    n = abs(cfg.coarse_gray_depth)
                    nglev = np.where(
                        m, (ii * n / max(rec.vmax, 1e-30)).astype(np.int64),
                        -1)
            else:
                nglev = np.full((bh, W), -1, np.int64)
            if "neigh" in accs:
                fam = "ngtdm" if need_ngtdm else "gldm"
                g = greyinfos[fam]
                lv2 = levs[g]
                v2 = np.ones((bh, W), bool) if g > 0 else lv2 > 0
                if need_ngtdm and v2.any():
                    maxlev_ngtdm = max(maxlev_ngtdm,
                                       int(np.where(v2, lv2, 0).max()))
                accs["neigh"].feed_block(orig, lv2, v2, nglev)
            for r in range(bh):
                if "glrlm" in accs:
                    g = greyinfos["glrlm"]
                    lv = levs[g][r]
                    vrow = np.ones(W, bool) if g > 0 else lv > 0
                    accs["glrlm"].feed_row(lv, vrow)
                if "glszm" in accs:
                    g = greyinfos["glszm"]
                    lv = levs[g][r]
                    vrow = np.ones(W, bool) if g > 0 else lv > 0
                    accs["glszm"].feed_row(lv, vrow)
                if "gldzm" in accs:
                    g = greyinfos["gldzm"]
                    lv = levs[g][r]
                    vrow = np.ones(W, bool) if g > 0 else lv > 0
                    accs["gldzm"].feed_row(lv, vrow, by + r - rec.y0)

    sweep(top_down=True)
    if "gldzm" in accs:
        sweep(top_down=False)

    vmin_a = _dev([rec.vmin], device)
    vmax_a = _dev([rec.vmax], device)
    out = {}

    if "glcm" in accs:
        from ..ops import glcm as ops_glcm
        g = greyinfos["glcm"]
        acc_g = accs["glcm"]
        if g < 0:
            # radiomics: rank-compact the dense-level matrices by the
            # present-level set and hand the reference's I-derived arrays
            # to the shared finalize (glcm.cpp:389-398, 503-513)
            ng = acc_g.ng
            M_dense = acc_g.finish(symmetric=True)[0]     # [A, ng, ng]
            I = np.nonzero(acc_g.present)[0]              # level-1 indices
            Mr = np.zeros((M_dense.shape[0], ng, ng))
            k = len(I)
            Mr[:, :k, :k] = M_dense[:, I][:, :, I]
            val = np.zeros((1, ng))
            val[0, :k] = I + 1.0
            kvs = np.zeros((1, 2 * ng - 1))
            kvd = np.zeros((1, ng))
            for x in range(k):
                for y in range(k):
                    kvs[0, x + y] = val[0, x] + val[0, y]
                    kvd[0, abs(x - y)] = abs(val[0, x] - val[0, y])
            res = ops_glcm.glcm_finalize(
                _dev(Mr[None], device), vmin_a, vmax_a, g, cfg.noval,
                ng_val=_dev([float(k)], device), val=_dev(val, device),
                kvs=_dev(kvs, device), kvd=_dev(kvd, device))
        else:
            M = _dev(acc_g.finish(symmetric=cfg.ibsi), device)
            res = ops_glcm.glcm_finalize(M, vmin_a, vmax_a, g, cfg.noval,
                                         vmax_a if cfg.ibsi else None)
        out["GLCMFeature"] = _host(res)

    if "glrlm" in accs:
        from ..ops import glrlm as ops_glrlm
        P = accs["glrlm"].finish()
        nr = _pow2(P.shape[-1])
        P = np.pad(P, ((0, 0), (0, 0), (0, 0), (0, nr - P.shape[-1])))
        res = ops_glrlm.glrlm_features(
            _dev(P, device), _dev([n_nonzero], device, torch.int64),
            vmin_a, vmax_a, cfg.noval, dt)
        out["GLRLMFeature"] = _host(res)

    if "glszm" in accs:
        from ..ops import glszm as ops_glszm
        g = greyinfos["glszm"]
        zlev, zsize, w = _agg_zones(*accs["glszm"].finish())
        Z = _pow2(zlev.shape[1])
        pad = ((0, 0), (0, Z - zlev.shape[1]))
        np_pixels = H * W if g > 0 else n_nonzero
        res = ops_glszm.glszm_features_from_zones(
            _dev(np.pad(zlev, pad), device), _dev(np.pad(zsize, pad), device),
            _dev(np.pad(w, pad), device),
            _dev([np_pixels], device, torch.int64), vmin_a, vmax_a,
            cfg.noval, dt, H * W + 1)
        out["GLSZMFeature"] = {k: float(v) for k, v in _host(res).items()}

    if ("gldzm" in accs) or (gldzm_plane is not None):
        from ..ops import gldzm as ops_gldzm
        if gldzm_plane is not None:
            zl, zdist = ot.gldzm_zones_plane(gldzm_plane)
            w_in = np.ones_like(zl)
            if zl.size == 0:        # no nonzero-level zones: dead w=0 row
                zl, zdist, w_in = np.zeros(1), np.zeros(1), np.zeros(1)
            zlev, zd, wz = _agg_zones(zl[None], zdist[None], w_in[None])
        else:
            zlev, zd, wz = _agg_zones(*ot.join_dz(accs["gldzm"].finish(),
                                                  accs["gldzm_b"].finish()))
        Z = _pow2(zlev.shape[1])
        pad = ((0, 0), (0, Z - zlev.shape[1]))
        res = ops_gldzm.gldzm_features_from_zones(
            _dev(np.pad(zlev, pad), device), _dev(np.pad(zd, pad), device),
            _dev(np.pad(wz, pad), device),
            _dev([rec.area], device, torch.int64), vmin_a, vmax_a,
            cfg.noval, dt, H + W + 2)
        out["GLDZMFeature"] = {k: float(v) for k, v in _host(res).items()}

    if "neigh" in accs:
        acc = accs["neigh"]
        acc.finish()        # process the AABB's last rows as centers
        if need_ngtdm:
            from ..ops import ngtdm as ops_ngtdm
            res = ops_ngtdm.ngtdm_stats(
                _dev(acc.N[None], device), _dev(acc.S[None], device),
                _dev(acc.present[None], device, torch.bool),
                _dev([[[maxlev_ngtdm]]], device, torch.int32),
                _dev([[[True]]], device, torch.bool), cfg.noval, dt,
                ibsi=cfg.ibsi)
            out["NGTDMFeature"] = {k: float(v) for k, v in _host(res).items()}
        if need_gldm:
            from ..ops import gldm as ops_gldm
            res = ops_gldm.gldm_features(_dev(acc.P_gldm[None], device),
                                         vmin_a, vmax_a, cfg.noval)
            out["GLDMFeature"] = {k: float(v) for k, v in _host(res).items()}
        if need_ngldm:
            from ..ops import ngldm as ops_ngldm
            res = ops_ngldm.ngldm_features_from_matrix(
                _dev(acc.P_ngldm[None], device), vmin_a, vmax_a, cfg.noval,
                dt)
            out["NGLDMfeature"] = {k: float(v) for k, v in _host(res).items()}
    return out


# which families this path can serve
STREAMABLE = ("PixelIntensityFeatures", "IntensityHistogramFeatures",
              "BasicMorphologyFeatures", "EllipseFittingFeature",
              "Imoms2D_feature", "Smoms2D_feature",
              # streamed phase-3 tail (pipeline/oversized_extra.py)
              "EulerNumberFeature", "ExtremaFeature", "ErosionPixelsFeature",
              "FractalDimensionFeature", "ZernikeFeature", "GaborFeature",
              "RoiRadiusFeature", "RadialDistributionFeature",
              "ChordsFeature",
              # streamed IMQ (pipeline/imq_streamed.py; the reference's
              # osized coverage is focus+saturation only -- power spectrum
              # and sharpness are empty stubs there, power_spectrum.h:28)
              "FocusScoreFeature", "SaturationFeature", "SharpnessFeature",
              "PowerSpectrumFeature") + TEX_FAMILIES


def _on_device(device, stream, fn):
    """``fn`` run with ``device`` current and, on a CUDA device, ``stream``
    (the caller's) current: a worker thread otherwise launches on its own
    current device's default stream."""
    def run():
        if device.type != "cuda":
            return fn()
        with torch.cuda.device(device), torch.cuda.stream(stream):
            return fn()
    return run


def process(rec, source, cfg, families, slide_min, slide_max,
            block: int = 2048, contour=None, hu_offset: float = 0.0,
            device="cpu"):
    """Full oversized-ROI pass.  Returns {family: {member: value}} for the
    streamable subset of ``families``.  ``contour`` is the streamed merged
    contour ([K, 3] int64, +1-shifted local coords) feeding the
    contour-distance families.  The finish stages run on ``device`` (the
    runner's), on its current stream."""
    from . import oversized_extra as ox
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)
    want = [f for f in families if f in STREAMABLE]
    if not want:
        return {}
    want_moments = ("Imoms2D_feature" in want) or ("Smoms2D_feature" in want)
    acc = accumulate(rec, source, block,
                     contour=contour if want_moments else None)
    if acc.area == 0:
        return {}
    # independent streamed passes fan over a small thread pool: every
    # source's region reads serialize on its lock (libtiff handles are not
    # thread-safe) while the numpy/native work overlaps -- the giant-ROI
    # wall is host-bound, and each family group re-sweeps the ROI on its
    # own (the reference's per-family osized_calculate threads similarly,
    # phase3.cpp:94-114)
    tasks = []
    tex_want = [f for f in want if f in TEX_FAMILIES]
    if tex_want:
        tasks.append(_on_device(device, stream, lambda: texture_members(
            rec, source, cfg, tex_want, slide_max, block, device)))
    if ("RoiRadiusFeature" in want) or ("RadialDistributionFeature" in want):
        tasks.append(lambda: ox.radial_streamed(
            rec, source, contour, "RoiRadiusFeature" in want,
            "RadialDistributionFeature" in want, block))
    if "ChordsFeature" in want:
        tasks.append(lambda: ox.chords_streamed(
            rec, source, cfg, cfg.ram_limit_mb << 20, block))
    imq_want = [f for f in want
                if f in ("FocusScoreFeature", "SaturationFeature",
                         "SharpnessFeature", "PowerSpectrumFeature")]
    if imq_want:
        from . import imq_streamed as oimq

        def imq_task():
            o = {}
            if "FocusScoreFeature" in imq_want:
                o["FocusScoreFeature"] = oimq.focus_score_streamed(
                    rec, source, block)
            if "SaturationFeature" in imq_want:
                o["SaturationFeature"] = oimq.saturation_streamed(
                    rec, source, block)
            if "SharpnessFeature" in imq_want:
                o["SharpnessFeature"] = oimq.sharpness_streamed(
                    rec, source, block)
            if "PowerSpectrumFeature" in imq_want:
                dt = np.float64 if cfg.precision == "f64" else np.float32
                mem = oimq.power_spectrum_streamed(rec, source, dt, block,
                                                   device)
                if mem:
                    o["PowerSpectrumFeature"] = mem
            return o
        tasks.append(_on_device(device, stream, imq_task))
    if "ZernikeFeature" in want:
        tasks.append(lambda: {"ZernikeFeature": ox.zernike_streamed(
            rec, acc, source, cfg.noval, block)})
    if "GaborFeature" in want:
        tasks.append(lambda: {"GaborFeature": ox.gabor_streamed(
            rec, acc, source, cfg, block)})

    out = {}
    if len(tasks) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as ex:
            for d in ex.map(lambda t: t(), tasks):
                out.update(d)
    elif tasks:
        out.update(tasks[0]())
    for fam in [f for f in want if f not in TEX_FAMILIES]:
        if fam in ("ZernikeFeature", "GaborFeature"):
            continue   # handled above (threaded fan)
        if fam == "PixelIntensityFeatures":
            out[fam] = intensity_members(acc, slide_min, slide_max, cfg,
                                         device)
        elif fam == "IntensityHistogramFeatures":
            out[fam] = ih_members(acc, cfg, slide_min, hu_offset, device)
        elif fam == "BasicMorphologyFeatures":
            cx = acc.S_shape[1, 0] / acc.area + rec.x0
            cy = acc.S_shape[0, 1] / acc.area + rec.y0
            comp = compactness_pass(rec, source, cx, cy, block)
            out[fam] = basic_morphology_members(rec, acc, comp, cfg)
        elif fam == "EllipseFittingFeature":
            out[fam] = ellipse_members(acc)
        elif fam == "EulerNumberFeature":
            out[fam] = ox.euler_streamed(rec, source, block)
        elif fam == "ExtremaFeature":
            out[fam] = ox.extrema_streamed(rec, source, block)
        elif fam == "ErosionPixelsFeature":
            out[fam] = ox.erosion_streamed(rec, source, block)
        elif fam == "FractalDimensionFeature":
            out[fam] = ox.fract_dim_boxcount_streamed(rec, source, block)
        elif fam == "ZernikeFeature":
            out[fam] = ox.zernike_streamed(rec, acc, source, cfg.noval, block)
        elif fam == "GaborFeature":
            out[fam] = ox.gabor_streamed(rec, acc, source, cfg, block)
        elif fam in ("RoiRadiusFeature", "RadialDistributionFeature",
                     "ChordsFeature", "FocusScoreFeature",
                     "SaturationFeature", "SharpnessFeature",
                     "PowerSpectrumFeature"):
            continue   # handled above (multi-family shared passes / IMQ)
        else:  # moments: one dict covers both prefixes, split by family
            mem = moments_members(acc)
            if fam == "Imoms2D_feature":
                out[fam] = {k: v for k, v in mem.items()
                            if k.startswith("IMOM")}
            else:
                # Smoms uses the legacy member names (registry._SMOM_RENAME)
                from .. import registry
                renamed = {}
                for k, v in mem.items():
                    if not k.startswith("SMOM"):
                        continue
                    tag = k[len("SMOM_"):]
                    if tag.startswith("WHU"):
                        renamed["WEIGHTED_HU_M" + tag[3:]] = v
                    elif tag.startswith("HU"):
                        renamed["HU_M" + tag[2:]] = v
                    else:
                        kind, pq = tag.rsplit("_", 1)
                        renamed["%s_%s" % (registry._SMOM_RENAME[kind], pq)] = v
                out[fam] = renamed
    return out
