# Copied verbatim from nyxus_tpu/pipeline/oversized_extra.py; pinned by tests/test_torch_tables.py.
"""Streamed oversized-ROI implementations for the phase-3 tail families:
Euler number, extrema, erosion count, box-count fractal dimension, Zernike,
Gabor, ROI radius, radial distribution, chords.

Each mirrors the trivial (dense-crop) kernel's numerics exactly or up to
documented float-order differences, while reading the ROI through the region
server in full-width strips so the dense AABB never materializes (reference
analog: per-feature ``osized_calculate`` over an OutOfRamPixelCloud,
phase3.cpp:94-114; e.g. erosion's nontriv path erosion.cpp, chords'
chords_nontriv.cpp, zernike_nontriv.cpp).
"""

from __future__ import annotations

import math

import numpy as np

# Euler quad patterns (euler_number.h:42-58), as in ops/binary.py
_P1 = (8, 4, 2, 1)
_P3 = (7, 11, 13, 14)
_PD = (9, 6)

_EROSION_CAP = 1000   # SANITY_MAX_NUM_EROSIONS (erosion.h:42)


def _strips(rec, source, block):
    """Yield (y_local_start, mask [bh, W] bool, intens [bh, W] f64)."""
    W = rec.width
    for by in range(rec.y0, rec.y1 + 1, block):
        bh = min(block, rec.y1 + 1 - by)
        ii, ll = source.read_pair(by, rec.x0, bh, W)
        yield by - rec.y0, ll == rec.label, ii


# ---------------------------------------------------------------------------
# Euler number (ops/binary.euler_number, euler_number.cpp:10-100)

def euler_streamed(rec, source, block=2048):
    W = rec.width
    c1 = c3 = cd = 0
    prev = np.zeros(W + 2, np.int32)    # previous padded row (top pad = 0)

    def count_quads(rows):
        """rows: [k, W+2] padded; counts quads between consecutive rows."""
        nonlocal c1, c3, cd
        q = (rows[:-1, :-1] * 8 + rows[:-1, 1:] * 4
             + rows[1:, :-1] * 2 + rows[1:, 1:])
        for v in _P1:
            c1 += int((q == v).sum())
        for v in _P3:
            c3 += int((q == v).sum())
        for v in _PD:
            cd += int((q == v).sum())

    for _, m, _ in _strips(rec, source, block):
        rows = np.zeros((m.shape[0] + 1, W + 2), np.int32)
        rows[0] = prev
        rows[1:, 1:-1] = m
        count_quads(rows)
        prev = rows[-1]
    count_quads(np.stack([prev, np.zeros(W + 2, np.int32)]))
    num = c1 - c3 - 2 * cd
    e = int(math.copysign(abs(num) // 4, num)) if num else 0
    return {"EULER_NUMBER": float(e)}


# ---------------------------------------------------------------------------
# Extrema (ops/radial.extrema, extrema.cpp)

def extrema_streamed(rec, source, block=2048):
    H, W = rec.height, rec.width
    BIGX, BIGY = W + 1, H + 1
    minx_top = minx_bot = BIGX
    maxx_top = maxx_bot = -1
    miny_left = miny_right = BIGY
    maxy_left = maxy_right = -1
    for y0l, m, _ in _strips(rec, source, block):
        bh = m.shape[0]
        if y0l == 0 and m[0].any():
            xs = np.nonzero(m[0])[0]
            minx_top, maxx_top = int(xs[0]), int(xs[-1])
        if y0l + bh == H and m[-1].any():
            xs = np.nonzero(m[-1])[0]
            minx_bot, maxx_bot = int(xs[0]), int(xs[-1])
        for col, attr in ((0, "left"), (W - 1, "right")):
            ys = np.nonzero(m[:, col])[0]
            if len(ys):
                lo, hi = int(ys[0]) + y0l, int(ys[-1]) + y0l
                if attr == "left":
                    miny_left = min(miny_left, lo)
                    maxy_left = max(maxy_left, hi)
                else:
                    miny_right = min(miny_right, lo)
                    maxy_right = max(maxy_right, hi)
    gx = lambda v: float(v + rec.x0)
    gy = lambda v: float(v + rec.y0)
    return {
        "EXTREMA_P1_Y": gy(0), "EXTREMA_P1_X": gx(minx_top),
        "EXTREMA_P2_Y": gy(0), "EXTREMA_P2_X": gx(maxx_top),
        "EXTREMA_P3_Y": gy(miny_right), "EXTREMA_P3_X": gx(W - 1),
        "EXTREMA_P4_Y": gy(maxy_right), "EXTREMA_P4_X": gx(W - 1),
        "EXTREMA_P5_Y": gy(H - 1), "EXTREMA_P5_X": gx(maxx_bot),
        "EXTREMA_P6_Y": gy(H - 1), "EXTREMA_P6_X": gx(minx_bot),
        "EXTREMA_P7_Y": gy(maxy_left), "EXTREMA_P7_X": gx(0),
        "EXTREMA_P8_Y": gy(miny_left), "EXTREMA_P8_X": gx(0),
    }


# ---------------------------------------------------------------------------
# Erosions-to-vanish (ops/binary.erosions_to_vanish, erosion.cpp:16-80)
#
# The iterated 3x3 cross erosion freezes the 2-pixel AABB border and counts
# iterations until the interior empties.  An interior mask pixel survives
# exactly d-1 erosions where d is its L1 (city-block) distance to the
# nearest zero reachable through interior cells; since the interior is a
# convex rectangle and usable zero sources are interior zeros or frozen
# border zeros one step away, the two-pass chamfer transform below is exact.
# Vanish count = max interior distance, capped at 1000 (INF = never = 1000).

_INF = np.int64(1 << 40)


def _row_relax(base):
    """min_j (base[j] + |x - j|) in O(W): two monotone scans."""
    x = np.arange(len(base), dtype=np.int64)
    left = np.minimum.accumulate(base - x) + x
    right = (np.minimum.accumulate((base + x)[::-1]))[::-1] - x
    return np.minimum(left, right)


def erosion_streamed(rec, source, block=2048):
    H, W = rec.height, rec.width
    # interior: 2 <= x <= W-2, 2 <= y <= H-2 (erosion.cpp:38-40)
    if H < 4 or W < 4:
        return {"EROSIONS_2_VANISH": 0.0, "EROSIONS_2_VANISH_COMPLEMENT": 0.0}
    xs = np.arange(W)
    in_x = (xs >= 2) & (xs <= W - 2)

    # Two streamed passes.  Pass 1 (top-down) runs the y-monotone forward
    # recurrence and remembers only the forward carry row entering each
    # strip.  Pass 2 (bottom-up) runs the backward recurrence; the final
    # distance needs forward and backward rows together, so pass 2
    # recomputes each strip's forward rows locally from the stored carry.
    # Full-row 1D relaxation in both passes is exact for L1 on the convex
    # interior (every shortest path can be made y-monotone).
    def seeds_for(m, y0l, bh):
        """Initial values for rows [y0l, y0l+bh): 0 at interior zeros,
        1-candidates next to frozen border zeros, INF otherwise; non-interior
        rows return None rows."""
        ys = np.arange(y0l, y0l + bh)
        rows = np.full((bh, W), _INF, np.int64)
        inter_y = (ys >= 2) & (ys <= H - 2)
        for k in range(bh):
            if not inter_y[k]:
                continue
            row = np.full(W, _INF, np.int64)
            mz = ~m[k]
            row[in_x & mz] = 0
            # frozen border-zero neighbors: x == 1 / x == W-1 zeros seed
            # x == 2 / x == W-2 with 1; y-adjacent handled via the y == 1 /
            # y == H-1 frozen rows below
            if not m[k][1]:
                row[2] = min(row[2], 1)
            if not m[k][W - 1]:
                row[W - 2] = min(row[W - 2], 1)
            rows[k] = row
        return rows, inter_y

    # pass 1: forward (up/left), remembering the carry row entering each
    # strip so pass 2 can recompute forward rows strip-locally
    carries = {}
    fwd_prev = np.full(W, _INF, np.int64)   # forward row above interior
    prev_border_row = None                  # frozen row y==1 mask
    strip_meta = []
    for y0l, m, _ in _strips(rec, source, block):
        bh = m.shape[0]
        carries[y0l] = fwd_prev.copy()
        strip_meta.append((y0l, bh))
        rows, inter_y = seeds_for(m, y0l, bh)
        ys = np.arange(y0l, y0l + bh)
        for k in range(bh):
            if not inter_y[k]:
                continue
            base = rows[k]
            # frozen row seeds: y == 1 (above) / y == H-1 (below) zeros
            if ys[k] == 2:
                up_mask_row = m[k - 1] if k >= 1 else (prev_border_row
                                                       if prev_border_row
                                                       is not None else None)
                if up_mask_row is not None:
                    base = np.where(in_x & ~up_mask_row,
                                    np.minimum(base, 1), base)
            base = np.minimum(base, fwd_prev + 1)
            base = np.where(in_x, _row_relax(
                np.where(in_x, base, _INF)), _INF)
            rows[k] = base
            fwd_prev = base
        prev_border_row = m[-1]
    # pass 2: backward (down/right), combining with recomputed forward rows
    bwd_next = np.full(W, _INF, np.int64)
    next_border_row = None                  # frozen row y == H-1 mask
    maxdt = 0
    for (y0l, bh) in reversed(strip_meta):
        ii, ll = source.read_pair(rec.y0 + y0l, rec.x0, bh, W)
        m = ll == rec.label
        rows, inter_y = seeds_for(m, y0l, bh)
        ys = np.arange(y0l, y0l + bh)
        # recompute forward rows for this strip from the stored carry
        fprev = carries[y0l]
        frows = np.full((bh, W), _INF, np.int64)
        for k in range(bh):
            if not inter_y[k]:
                continue
            base = rows[k]
            if ys[k] == 2 and k >= 1:
                base = np.where(in_x & ~m[k - 1], np.minimum(base, 1), base)
            elif ys[k] == 2:
                # row y==1 lives in the previous strip; its seed contribution
                # was already folded into the stored carry during pass 1 via
                # fwd_prev? no -- fold via carry is not possible, so re-read
                prev_ii, prev_ll = source.read_pair(
                    rec.y0 + y0l - 1, rec.x0, 1, W)
                base = np.where(in_x & ~(prev_ll[0] == rec.label),
                                np.minimum(base, 1), base)
            base = np.minimum(base, fprev + 1)
            base = np.where(in_x, _row_relax(
                np.where(in_x, base, _INF)), _INF)
            frows[k] = base
            fprev = base
        # backward sweep within the strip
        for k in range(bh - 1, -1, -1):
            if not inter_y[k]:
                continue
            base = rows[k]
            if ys[k] == H - 2:
                dn_mask_row = (m[k + 1] if k + 1 < bh else
                               (next_border_row if next_border_row
                                is not None else None))
                if dn_mask_row is None:
                    ii2, ll2 = source.read_pair(
                        rec.y0 + y0l + k + 1, rec.x0, 1, W)
                    dn_mask_row = ll2[0] == rec.label
                base = np.where(in_x & ~dn_mask_row,
                                np.minimum(base, 1), base)
            base = np.minimum(base, bwd_next + 1)
            base = np.where(in_x, _row_relax(
                np.where(in_x, base, _INF)), _INF)
            bwd_next = base
            d = np.minimum(frows[k], base)
            alive = m[k] & in_x & (ys[k] >= 2) & (ys[k] <= H - 2)
            if alive.any():
                maxdt = max(maxdt, int(d[alive].max()))
        next_border_row = m[0]
    # the dense kernel does not count the iteration whose erosion empties
    # the interior (ops/binary.py body: n stays when now_done), so the
    # reported count is max-distance - 1; never-vanishing ROIs hit the cap
    count = min(max(maxdt - 1, 0), _EROSION_CAP)
    return {"EROSIONS_2_VANISH": float(count),
            "EROSIONS_2_VANISH_COMPLEMENT": 0.0}


# ---------------------------------------------------------------------------
# Box-count fractal dimension (ops/binary.fract_dim_boxcount,
# fractal_dim.cpp:16-77)

def fract_dim_boxcount_streamed(rec, source, block=2048):
    from . import batching
    H, W = rec.height, rec.width
    hb, wb = (batching.bucket_shape(H, W)
              if max(H, W) <= batching._LADDER[-1] else
              (1 << (H - 1).bit_length(), 1 << (W - 1).bit_length()))
    SB = 1
    while SB < max(hb, wb):
        SB *= 2
    padded_side = max(2, 1 << (max(H, W) - 1).bit_length())
    scales = []
    s = SB
    while s > 1:
        scales.append(s)
        s //= 2
    shifted = padded_side <= 32

    # per (s, ox, oy): [active_box_row, occ cols bool, total]
    grids = {}
    for s in scales:
        shifts = [(0, 0)]
        if shifted and s <= 32:
            shifts += [(s // 2, 0), (0, s // 2), (s // 2, s // 2)]
        for (ox, oy) in shifts:
            nbc = (W + ox + s - 1) // s
            grids[(s, ox, oy)] = [-1, np.zeros(nbc, bool), 0]

    for y0l, m, _ in _strips(rec, source, block):
        bh = m.shape[0]
        for (s, ox, oy), st in grids.items():
            brs = (np.arange(y0l, y0l + bh) + oy) // s
            # segment strip rows by box row
            change = np.nonzero(np.diff(brs))[0] + 1
            seg_starts = np.concatenate([[0], change])
            seg_ends = np.concatenate([change, [bh]])
            for a, b in zip(seg_starts, seg_ends):
                br = int(brs[a])
                colmask = m[a:b].any(axis=0)
                nbc = len(st[1])
                padded = np.zeros(nbc * s, bool)
                padded[ox:ox + W] = colmask
                occ = padded.reshape(nbc, s).any(axis=1)
                if br == st[0]:
                    st[1] |= occ
                else:
                    st[2] += int(st[1].sum())
                    st[0], st[1] = br, occ
    counts = {}
    for key, st in grids.items():
        counts[key] = st[2] + int(st[1].sum())

    sx = sy = sxy = sx2 = nuse = 0.0
    for s in scales:
        plain = counts[(s, 0, 0)]
        if shifted and s <= 32:
            cnt = min(plain, counts[(s, s // 2, 0)], counts[(s, 0, s // 2)],
                      counts[(s, s // 2, s // 2)])
        else:
            cnt = plain
        if s <= padded_side and cnt > 0:
            lx, ly = math.log(s), math.log(cnt)
            sx += lx
            sy += ly
            sxy += lx * ly
            sx2 += lx * lx
            nuse += 1
    denom = nuse * sx2 - sx * sx
    slope = (nuse * sxy - sx * sy) / denom if denom != 0 else 0.0
    return {"FRACT_DIM_BOXCOUNT": -slope}


# ---------------------------------------------------------------------------
# Zernike moments (ops/zernike.py numpy mirror; zernike.cpp mb_zernike2D)

def zernike_streamed(rec, acc, source, noval, block=2048):
    from ..ops.zernike import ORDER, _H1, _H2, _H3
    if acc.vmax == acc.vmin:
        return {"ZERNIKE2D": np.full(30, noval)}
    L = ORDER
    s_tot = acc.S_int[0, 0]
    # intensity centroid in 1-based local coords (xs = arange(1, W+1))
    cx = (acc.S_int[1, 0] + s_tot) / max(s_tot, 1e-30)
    cy = (acc.S_int[0, 1] + s_tot) / max(s_tot, 1e-30)
    rad = float(min(rec.height, rec.width))
    eps = np.finfo(np.float64).eps

    pairs = [(n_, m_) for n_ in range(L + 1) for m_ in range(n_ + 1)
             if (n_ - m_) % 2 == 0]
    AR = np.zeros(len(pairs))
    AI = np.zeros(len(pairs))

    for y0l, m, ii in _strips(rec, source, block):
        ys, xs = np.nonzero(m)
        if not len(ys):
            continue
        img = ii[ys, xs].astype(np.float64)
        x = ((xs + 1).astype(np.float64) - cx) / rad
        y = ((ys + y0l + 1).astype(np.float64) - cy) / rad
        r2 = x * x + y * y
        r = np.sqrt(r2)
        ok = (r >= eps) & (r <= 1.0)
        if not ok.any():
            continue
        x, y, r, r2, img = x[ok], y[ok], r[ok], r2[ok], img[ok]
        f = img / max(s_tot, 1e-30)
        inv_r = 1.0 / r
        cost = [x * inv_r]
        sint = [y * inv_r]
        for m_ in range(1, L + 1):
            cost.append(cost[0] * cost[-1] - sint[0] * sint[-1])
            sint.append(cost[0] * sint[-1] + sint[0] * cost[m_ - 1])
        R = [np.ones_like(r)]
        for n_ in range(1, L + 1):
            R.append(r * R[-1])
        inv_r2 = 1.0 / r2
        pi_ = 0
        for n_ in range(L + 1):
            const_t = (n_ + 1) / math.pi
            Rn = R[n_]
            Rnm2 = R[n_ - 2] if n_ >= 2 else None
            Rnmp2 = Rnmp4 = None
            rnm_by_m = {}
            for m_ in range(n_, -1, -2):
                if m_ == n_:
                    Rnm = Rn
                    Rnmp4 = Rn
                elif m_ == n_ - 2:
                    Rnm = n_ * Rn - (n_ - 1) * Rnm2
                    Rnmp2 = Rnm
                else:
                    Rnm = (_H1[n_][m_] * Rnmp4
                           + (_H2[n_][m_] + _H3[n_][m_] * inv_r2) * Rnmp2)
                    Rnmp4 = Rnmp2
                    Rnmp2 = Rnm
                rnm_by_m[m_] = Rnm
            for m_ in range(n_ + 1):
                if (n_ - m_) % 2 != 0:
                    continue
                Rnm = rnm_by_m[m_]
                AR[pi_] += float((const_t * f * Rnm * cost[m_]).sum())
                AI[pi_] -= float((const_t * f * Rnm * sint[m_]).sum())
                pi_ += 1
    return {"ZERNIKE2D": np.sqrt(AR * AR + AI * AI)}


# ---------------------------------------------------------------------------
# Gabor (ops/gabor.py mirror; gabor.cpp conv_dud + thresholded energy)

def _conv_mag_strip(img, kr, ki, n, y_from, y_to, H, rec, source, W,
                    block_read):
    """floor(|full-conv|) for output rows [y_from, y_to) of the AABB,
    reading the halo rows it needs (zeros outside the AABB)."""
    from scipy.signal import fftconvolve
    off = int(math.ceil(n / 2))
    top = n - 1 - off
    bot = off
    a = y_from - top
    b = y_to + bot
    rows = np.zeros((b - a, W), np.float64)
    ra, rb = max(a, 0), min(b, H)
    if rb > ra:
        ii, ll = source.read_pair(rec.y0 + ra, rec.x0, rb - ra, W)
        rows[ra - a:rb - a] = np.where(ll == rec.label, ii, 0.0)
    k = kr + 1j * ki
    out = fftconvolve(rows, k, mode="full")
    # crop cols like the dense kernel: off .. off + W
    out = out[:, off:off + W]
    # rows: full output row t corresponds to input row t - (n - 1); the
    # dense kernel keeps rows off .. off + H of the full conv; our rows
    # buffer starts at AABB row a, so AABB output row y sits at
    # (y + off) - a in this buffer's full-conv rows
    sel = out[(y_from + off - a):(y_to + off - a), :]
    return np.floor(np.abs(sel))


def gabor_streamed(rec, acc, source, cfg, block=2048):
    from ..ops.gabor import gabor_kernel
    H, W = rec.height, rec.width
    n = cfg.gabor_kersize
    if acc.vmax == acc.vmin:
        return {"GABOR": np.zeros(len(cfg.gabor_freqs))}
    kr0, ki0 = gabor_kernel(cfg.gabor_f0, cfg.gabor_sig2lam,
                            cfg.gabor_gamma, math.pi / 2, n)
    maxval = -np.inf
    minval = np.inf
    min_count = 0
    N = H * W
    for y_from in range(0, H, block):
        y_to = min(y_from + block, H)
        base = _conv_mag_strip(None, kr0, ki0, n, y_from, y_to, H, rec,
                               source, W, block)
        bmax = float(base.max())
        bmin = float(base.min())
        if bmax > maxval:
            maxval = bmax
        if bmin < minval:
            minval = bmin
            min_count = int((base == bmin).sum())
        elif bmin == minval:
            min_count += int((base == bmin).sum())
    baseline = N - min_count            # count(base > cmpval)
    if maxval == minval:
        return {"GABOR": np.full(len(cfg.gabor_freqs), cfg.noval)}

    hits = np.zeros(len(cfg.gabor_freqs))
    kernels = []
    for theta_deg, freq in zip(cfg.gabor_thetas, cfg.gabor_freqs):
        # faithful swapped unpacking (see ops/gabor.gabor_features)
        kernels.append(gabor_kernel(math.radians(theta_deg),
                                    cfg.gabor_sig2lam, cfg.gabor_gamma,
                                    float(freq), n))
    for y_from in range(0, H, block):
        y_to = min(y_from + block, H)
        for fi, (kr, ki) in enumerate(kernels):
            mag = _conv_mag_strip(None, kr, ki, n, y_from, y_to, H, rec,
                                  source, W, block)
            hits[fi] += int((mag / max(maxval, 1e-30)
                             > cfg.gabor_thold).sum())
    return {"GABOR": hits / max(baseline, 1)}


# ---------------------------------------------------------------------------
# ROI radius + radial distribution (hostfeats mirrors; roi_radius.cpp,
# radial_distribution.cpp) over the STREAMED contour

def radial_streamed(rec, source, contour, want_radius, want_radial,
                    block=2048):
    from .. import native
    if contour is None or contour.shape[0] == 0:
        return {}
    cxv = contour[:, 0].astype(np.float64)
    cyv = contour[:, 1].astype(np.float64)

    # pass 1: per-pixel approx distances; ROI-radius stats + radial center
    r_sum = 0.0
    r_max = 0.0
    n_pix = 0
    med_vals = np.zeros(0, np.uint64)
    med_cnts = np.zeros(0, np.int64)
    best = np.inf
    center = None
    for y0l, m, ii in _strips(rec, source, block):
        ys, xs = np.nonzero(m)
        if not len(ys):
            continue
        lx = xs.astype(np.float64)
        ly = (ys + y0l).astype(np.float64)
        mind2, maxd2 = native.contour_sqdist_approx(
            lx, ly, cxv, cyv, want_min=True, want_max=want_radial)
        n_pix += len(lx)
        if want_radius:
            r_sum += float(mind2.sum())
            r_max = max(r_max, float(mind2.max()))
            u, c = np.unique(mind2.astype(np.uint64), return_counts=True)
            allv = np.concatenate([med_vals, u])
            allc = np.concatenate([med_cnts, c])
            uu, inv = np.unique(allv, return_inverse=True)
            cc = np.zeros(uu.size, np.int64)
            np.add.at(cc, inv, allc)
            med_vals, med_cnts = uu, cc
        if want_radial:
            diff = maxd2 - mind2
            k = int(np.argmin(diff))
            if diff[k] < best:
                best = diff[k]
                center = (int(lx[k]), int(ly[k]), math.sqrt(maxd2[k]))
    out = {}
    if n_pix == 0:
        return out
    if want_radius:
        cum = np.cumsum(med_cnts)
        half = n_pix // 2
        if n_pix % 2:
            med = float(med_vals[np.searchsorted(cum, half + 1)])
        else:
            lo = float(med_vals[np.searchsorted(cum, half)])
            hi = float(med_vals[np.searchsorted(cum, half + 1)])
            med = (lo + hi) / 2.0
        out["RoiRadiusFeature"] = {
            "ROI_RADIUS_MEAN": r_sum / n_pix,
            "ROI_RADIUS_MAX": r_max,
            "ROI_RADIUS_MEDIAN": med,
        }
    if want_radial and center is not None:
        NB = 8
        eps = 1e-9
        cx, cy, dstOC = center
        counts = np.zeros(NB)
        intb = np.zeros(NB)
        wedges = np.zeros((NB, NB))
        for y0l, m, ii in _strips(rec, source, block):
            ys, xs = np.nonzero(m)
            if not len(ys):
                continue
            inten = ii[ys, xs].astype(np.float64)
            dx = xs.astype(np.float64) - cx
            dy = (ys + y0l).astype(np.float64) - cy
            dstOA = np.sqrt(dx * dx + dy * dy)
            rat = dstOA / dstOC if dstOC > 0 else np.zeros_like(dstOA)
            bi = np.minimum((rat * (NB - 1)).astype(np.int64), NB - 1)
            ang = np.arctan2(dy, dx)
            ang = np.where(ang < 0, 2.0 * math.pi + ang, ang)
            wb = np.minimum((ang / (2.0 * math.pi / NB)).astype(np.int64),
                            NB - 1)
            counts += np.bincount(bi, minlength=NB)
            intb += np.bincount(bi, weights=inten, minlength=NB)
            np.add.at(wedges, (bi, wb), inten)
        wmean = wedges.sum(axis=1) / NB
        wvar = ((wedges - wmean[:, None]) ** 2).sum(axis=1) / NB
        out["RadialDistributionFeature"] = {
            "FRAC_AT_D": counts / (n_pix + eps),
            "MEAN_FRAC": intb / (counts + eps),
            "RADIAL_CV": np.sqrt(wvar) / (wmean + eps),
        }
    return out


# ---------------------------------------------------------------------------
# Chords (hostfeats.chords_py semantics, banded by rotated column so the
# full rotated raster never materializes; chords.cpp + chords_nontriv.cpp)

def chords_streamed(rec, source, cfg, budget_bytes, block=2048):
    n_side_segments = 100
    ang_step = math.pi / 20
    angs = []
    a = 0.0
    while a < math.pi:
        angs.append(a)
        a += ang_step
    angs = np.asarray(angs)
    sin_a = np.array([float(np.float32(math.sin(float(np.float32(t)))))
                      for t in angs])
    cos_a = np.array([float(np.float32(math.cos(float(np.float32(t)))))
                      for t in angs])
    if rec.report_bbox is not None:
        ry0, ry1, rx0, rx1 = rec.report_bbox
        cenx, ceny = (rx0 + rx1) / 2.0, (ry0 + ry1) / 2.0
    else:
        cenx = (rec.x0 + rec.x1) / 2.0
        ceny = (rec.y0 + rec.y1) / 2.0

    # prepass: global rotated extents per angle (exact, streamed)
    A = len(angs)
    minx = np.full(A, np.int64(1) << 60)
    maxx = np.full(A, -(np.int64(1) << 60))
    miny = np.full(A, np.int64(1) << 60)
    maxy = np.full(A, -(np.int64(1) << 60))
    area = 0
    for y0l, m, ii in _strips(rec, source, block):
        ys, xs = np.nonzero(m)
        if not len(ys):
            continue
        area += len(ys)
        gx = (xs + rec.x0).astype(np.float64)
        gy = (ys + y0l + rec.y0).astype(np.float64)
        for ai in range(A):
            xr = ((gx - cenx) * cos_a[ai] - (gy - ceny) * sin_a[ai]
                  + cenx).astype(np.float32).astype(np.int64)
            yr = ((gy - ceny) * cos_a[ai] + (gx - cenx) * sin_a[ai]
                  + ceny).astype(np.float32).astype(np.int64)
            minx[ai] = min(minx[ai], xr.min())
            maxx[ai] = max(maxx[ai], xr.max())
            miny[ai] = min(miny[ai], yr.min())
            maxy[ai] = max(maxy[ai], yr.max())
    if area == 0:
        return {}

    MCv, MCang, ACl, ACang = [], [], [], []
    for ai in range(A):
        wr = int(maxx[ai] - minx[ai] + 1)
        hr_bottom = int(maxy[ai] - miny[ai])
        step = wr // n_side_segments if wr >= 2 * n_side_segments else 1
        # band count from the SELECTED pixel estimate: only every step-th
        # rotated column participates (~1/step of the area), so sizing
        # bands by the full area forced ~step x more re-scans than the
        # memory bound needs (each re-scan re-rotates every ROI pixel)
        sel_est = area // max(step, 1) + 1
        nbands = max(1, int(sel_est * 32 // max(budget_bytes, 1 << 20)) + 1)
        band_w = (wr + nbands - 1) // nbands
        ang_best = 0
        ang_any = False
        for band in range(nbands):
            bx0 = band * band_w
            bx1 = min(wr, bx0 + band_w)
            if bx0 >= bx1:
                continue
            xs_l, ys_l, it_l, ord_l = [], [], [], []
            order_base = 0
            for y0l, m, ii in _strips(rec, source, block):
                ys, xs = np.nonzero(m)
                if not len(ys):
                    continue
                gx = (xs + rec.x0).astype(np.float64)
                gy = (ys + y0l + rec.y0).astype(np.float64)
                xr = ((gx - cenx) * cos_a[ai] - (gy - ceny) * sin_a[ai]
                      + cenx).astype(np.float32).astype(np.int64) - minx[ai]
                sel = (xr >= bx0) & (xr < bx1) & ((xr % step) == 0)
                if sel.any():
                    # yr only for the ~1/step selected pixels
                    yr = ((gy[sel] - ceny) * cos_a[ai]
                          + (gx[sel] - cenx) * sin_a[ai]
                          + ceny).astype(np.float32).astype(np.int64) \
                        - miny[ai]
                    xs_l.append(xr[sel])
                    ys_l.append(yr)
                    it_l.append(ii[ys, xs][sel].astype(np.float64))
                    ord_l.append(np.nonzero(sel)[0] + order_base)
                order_base += len(ys)
            if not xs_l:
                continue
            x_k = np.concatenate(xs_l)
            y_k = np.concatenate(ys_l)
            i_k = np.concatenate(it_l)
            c_k = np.concatenate(ord_l)
            order = np.lexsort((c_k, y_k, x_k))
            x_s, y_s, i_s = x_k[order], y_k[order], i_k[order]
            if len(x_s) > 1:
                last = np.empty(len(x_s), bool)
                last[-1] = True
                last[:-1] = (x_s[1:] != x_s[:-1]) | (y_s[1:] != y_s[:-1])
                x_s, y_s, i_s = x_s[last], y_s[last], i_s[last]
            nz = i_s != 0
            x_s, y_s = x_s[nz], y_s[nz]
            if len(x_s) == 0:
                continue
            newrun = np.empty(len(x_s), bool)
            newrun[0] = True
            newrun[1:] = (x_s[1:] != x_s[:-1]) | (y_s[1:] != y_s[:-1] + 1)
            run_start = np.nonzero(newrun)[0]
            run_len = np.diff(np.append(run_start, len(x_s)))
            run_x = x_s[run_start]
            run_end_y = y_s[run_start] + run_len - 1
            term = run_end_y != hr_bottom
            run_x, run_len = run_x[term], run_len[term]
            if len(run_x) == 0:
                continue
            newcol = np.empty(len(run_x), bool)
            newcol[0] = True
            newcol[1:] = run_x[1:] != run_x[:-1]
            col_start = np.nonzero(newcol)[0]
            AC = np.maximum.reduceat(run_len, col_start).astype(np.float64)
            ACl.extend(AC.tolist())
            ACang.extend([angs[ai]] * len(AC))
            b_best = int(AC.max())
            if not ang_any or b_best > ang_best:
                ang_best, ang_any = b_best, True
        if ang_any:
            MCv.append(float(ang_best))
            MCang.append(angs[ai])
    if not MCv:
        return {}
    names = ("MAX", "MAX_ANG", "MIN", "MIN_ANG", "MEDIAN", "MEAN", "MODE",
             "STDDEV")
    out = {}

    def stats(V, Aang, Hvals):
        V = np.asarray(V)
        Hvals = np.asarray(Hvals)
        mean = V.mean()
        std = (math.sqrt(((V - mean) ** 2).sum() / (len(V) - 1))
               if len(V) > 2 else 0.0)
        sv = np.sort(Hvals)
        half = len(sv) // 2
        median = sv[half] if len(sv) % 2 else (sv[half - 1] + sv[half]) / 2.0
        vals, cnts = np.unique(Hvals, return_counts=True)
        mode = vals[int(np.argmax(cnts))]
        return {"MAX": V.max(), "MAX_ANG": Aang[int(np.argmax(V))],
                "MIN": V.min(), "MIN_ANG": Aang[int(np.argmin(V))],
                "MEDIAN": median, "MEAN": mean, "MODE": mode, "STDDEV": std}

    mc = stats(MCv, np.asarray(MCang), MCv)
    # un-cleared TrivialHistogram quirk: ALLCHORDS mode/median over MC + AC
    ac = stats(ACl, np.asarray(ACang), np.asarray(MCv + ACl))
    for tag in names:
        out["MAXCHORDS_" + tag] = mc[tag]
        out["ALLCHORDS_" + tag] = ac[tag]
    return {"ChordsFeature": out}
