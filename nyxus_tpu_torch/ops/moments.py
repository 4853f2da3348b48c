"""2D geometric moments (intensity + shape): raw/central/normalized/Hu and
their distance-to-contour weighted variants (PyTorch port of
nyxus_tpu/ops/moments.py).  Batched.

Reference: src/nyx/features/2d_geomoments_basic.cpp:69-380, 2d_geomoments.h.
Coordinates are AABB-local (x - xmin, y - ymin); weighted intensities are
I * log(dist_to_contour + 0.001) with dist the min Euclidean distance to the
(+1,+1)-shifted merged contour.

Member naming: IMOM_* (intensity) / SMOM_* (shape) x {RM_pq raw, CM_pq
central, NRM_pq normalized raw, NCM_pq normalized central, HU1-7,
weighted W* variants}.

The power sums are K10 ``power_sums`` (csrc/power_sums.cu), written by hand
for the card: one launch a bucket gives every raw and centred sum and every
centroid the moment, morphology, ellipse and Zernike families read
(``moment_sums``, cached on the BatchContext).  Its plain PyTorch version,
``moment_sums_plain``, forms every term as JAX does (the only path for a
tensor on the CPU; a CUDA tensor launches the kernel or raises).  Both
accumulate in float64 whatever the compute dtype.  The normalisations, Hu
invariants and the signed powers stay torch.
"""

from __future__ import annotations

import typing

import torch

from .. import _build
from .common import (SMEM_MAX, SMS, _check_float, _kernel_device, roi_sizes,
                     safe_div)

RAW_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
          (2, 0), (2, 1), (2, 2), (2, 3), (3, 0)]
CENTRAL_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
              (2, 0), (2, 1), (2, 2), (2, 3), (3, 0), (3, 1), (3, 2), (3, 3)]
NORM_RAW_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
               (2, 0), (2, 1), (2, 2), (2, 3), (3, 0), (3, 1), (3, 2), (3, 3)]
NORM_CENTRAL_PQ = [(0, 2), (0, 3), (1, 1), (1, 2), (2, 0), (2, 1), (3, 0)]
W_RAW_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2),
            (2, 0), (2, 1), (3, 0)]
W_CENTRAL_PQ = [(0, 2), (0, 3), (1, 1), (1, 2), (2, 0), (2, 1), (3, 0)]

WEIGHTING_EPSILON = 0.001

# K10's launch plan (power_sums_plan): threads a block at most, and the
# pixels a thread takes before a block takes more threads; blocks (a
# cluster) a (ROI, plane, centre) at most; crops above PS_FILL_PX pixels
# are split over a cluster while the batch leaves SMs idle; the kernel's
# static shared memory (the warps' sums, the blocks' parts and the totals)
PS_THREADS = 256
PS_PX = 4
PS_CLUSTER = 16
PS_FILL_PX = 4096
PS_STATIC_SMEM = 8 * (PS_THREADS // 32 * 16 + 2 * 16 + 4)


class MomentSums(typing.NamedTuple):
    """K10's sums of one bucket.  Planes p: 0 the mask (0/1 weights), 1
    the masked intensity, 2 the masked intensity * logw, 3 the mask * logw
    (2 and 3 only where logw is given).  raw, central: float64 [B, P, 4,
    4], S[b, p, i, j] = sum w_p (x - ox)^i (y - oy)^j, raw around 0,
    central around the plane's own centroid; ellipse: float64 [B, 4, 4],
    the mask's sums around (S10 / area, S01 / area); centres: [B, P + 1, 2]
    in the compute dtype, each plane's centroid, then the ellipse's."""
    raw: torch.Tensor
    central: torch.Tensor
    ellipse: torch.Tensor
    centres: torch.Tensor


def power_sums_plain(planes, centre=None):
    """JAX's _power_sums (moments.py:36) for each plane, the sum taken in
    float64: the oracle of K10's terms.  planes: list of [B, H, W] weight
    planes; centre: None or [B, P, 2] (ox, oy) per plane -> float64 [B, P,
    4, 4], S[b, p, i, j] = sum w_p (x - ox)^i (y - oy)^j."""
    w0 = planes[0]
    B, H, W = w0.shape
    dt = w0.dtype
    xs = torch.arange(W, dtype=dt, device=w0.device)[None, None, :] \
        * torch.ones((1, H, 1), dtype=dt, device=w0.device)
    ys = torch.arange(H, dtype=dt, device=w0.device)[None, :, None] \
        * torch.ones((1, 1, W), dtype=dt, device=w0.device)
    out = []
    for k, w in enumerate(planes):
        x, y = xs, ys
        if centre is not None:
            x = xs - centre[:, k, 0, None, None]
            y = ys - centre[:, k, 1, None, None]
        xp = [torch.ones_like(x), x, x * x, x * x * x]
        yq = [torch.ones_like(y), y, y * y, y * y * y]
        S = torch.empty((B, 4, 4), dtype=torch.float64, device=w0.device)
        for p in range(4):
            wx = w * xp[p]
            for q in range(4):
                S[:, p, q] = (wx * yq[q]).to(torch.float64).sum(dim=(1, 2))
        out.append(S)
    return torch.stack(out, dim=1)


def moment_planes(weights, logw=None):
    """One weighting mode's planes: the weights, and the contour-weighted
    weights * logw when logw is given."""
    if logw is None:
        return [weights]
    return [weights, weights * logw.to(weights.dtype)]


def moment_sums_plain(intens, mask, area, logw=None):
    """Plain version of K10: the torch calls the families made one by one,
    in the compute dtype of ``intens`` ([B, H, W]; ``mask`` bool [B, H,
    W]; ``area`` [B] pixel counts; ``logw`` None or [B, H, W]) ->
    MomentSums.  The planes by moment_planes, each plane's raw sums and its
    safe_div centroid from them cast to the compute dtype, the ellipse's
    centroid S10 / area, S01 / area, and the centred sums by
    power_sums_plain."""
    dt = intens.dtype
    mw = mask.to(dt)
    mi = torch.where(mask, intens, 0)
    planes = [mw, mi]
    if logw is not None:
        planes = [mw, mi, moment_planes(mi, logw)[1],
                  moment_planes(mw, logw)[1]]
    P = len(planes)
    raw = power_sums_plain(planes)
    centres = []
    for k in range(P):
        S = raw[:, k].to(dt)
        centres.append(torch.stack([safe_div(S[:, 1, 0], S[:, 0, 0]),
                                    safe_div(S[:, 0, 1], S[:, 0, 0])], dim=1))
    S = raw[:, 0].to(dt)
    n = area.to(dt)
    centres.append(torch.stack([S[:, 1, 0] / n, S[:, 0, 1] / n], dim=1))
    centres = torch.stack(centres, dim=1)
    central = power_sums_plain(planes, centres[:, :P])
    ellipse = power_sums_plain([mw], centres[:, P:])[:, 0]
    return MomentSums(raw, central, ellipse, centres)


def power_sums_plan(B: int, H: int, W: int, esz: int, P: int = 4):
    """(path, C, chunk, threads, smem) of K10's launch over B crops of H x
    W, P planes of esz-byte elements, P + 1 (plane, centre) pairs a ROI
    (each plane around its own centre, and the mask around the ellipse's).
    C blocks (a thread-block cluster) a (ROI, plane, centre), block r taking
    pixels [r * chunk, (r + 1) * chunk): the fewest whose chunk fits a
    block's shared memory beside the static PS_STATIC_SMEM, raised for
    crops above PS_FILL_PX pixels until the batch's blocks cover the SMS,
    at most PS_CLUSTER.  "staged": the chunk
    of the plane is held in smem bytes of shared memory for the second
    pass; "global": it does not fit even at PS_CLUSTER blocks, and the
    second pass forms it again from the inputs (smem 0).  threads: the
    least power of two from 64 to PS_THREADS that takes a chunk at PS_PX
    pixels a thread."""
    A = H * W
    room = SMEM_MAX - PS_STATIC_SMEM
    C = -(-A * esz // room)
    if A > PS_FILL_PX:
        C = max(C, -(-SMS // max(1, B * (P + 1))))
    C = max(1, min(PS_CLUSTER, C))
    chunk = -(-A // C)
    if A:
        C = -(-A // chunk)
    smem = chunk * esz if chunk * esz <= room else 0
    threads = 64
    while threads < PS_THREADS and threads * PS_PX < chunk:
        threads *= 2
    return ("staged" if smem else "global", C, chunk, threads, smem)


def moment_power_sums(intens, mask, area, logw=None):
    """K10 power_sums (csrc/power_sums.cu), replacing
    nyxus_tpu/ops/moments.py:36 _power_sums as :49 moments_all calls it,
    the coordinate sums of nyxus_tpu/ops/morphology.py and Zernike's
    centroid sums: every sum and centre of moment_sums_plain (the
    arguments and result) in one launch, the planes formed in the kernel.
    A cluster of blocks a (ROI, plane, centre) by power_sums_plan."""
    if not _kernel_device(intens, "power_sums"):
        return moment_sums_plain(intens, mask, area, logw)
    _check_float(intens, "power_sums")
    if intens.dim() != 3 or mask.shape != intens.shape \
            or mask.dtype != torch.bool or area.shape != intens.shape[:1] \
            or (logw is not None and (logw.shape != intens.shape
                                      or logw.dtype != intens.dtype)) \
            or any(t.device != intens.device
                   for t in (mask, area) + ((logw,) if logw is not None
                                            else ())):
        raise ValueError("power_sums: intens %s needs a bool mask, [B] areas "
                         "and a logw plane of its shape, dtype and device"
                         % (tuple(intens.shape),))
    B, H, W = intens.shape
    P = 2 if logw is None else 4
    dt = intens.dtype
    sums = torch.empty((B, 2 * P + 1, 4, 4), dtype=torch.float64,
                       device=intens.device)
    centres = torch.empty((B, P + 1, 2), dtype=dt, device=intens.device)
    out = MomentSums(sums[:, :P], sums[:, P:2 * P], sums[:, 2 * P], centres)
    if B == 0:
        return out
    intens = intens.contiguous()
    mask = mask.contiguous()
    if logw is not None:
        logw = logw.contiguous()
    area, astride = roi_sizes(area)
    _, C, chunk, threads, smem = power_sums_plan(B, H, W,
                                                 intens.element_size(), P)
    code = _build.lib().nyx_power_sums(
        intens.data_ptr(), mask.data_ptr(),
        None if logw is None else logw.data_ptr(), area.data_ptr(),
        astride, sums.data_ptr(), centres.data_ptr(), B, P, H, W, C,
        chunk, threads, smem, int(dt == torch.float64),
        _build.stream_of(intens, "power_sums"))
    _build.check("power_sums", code)
    moment_power_sums.launches += 1
    return out


moment_power_sums.launches = 0


def moment_sums(ctx):
    """K10's MomentSums of the batch, one launch shared by the moment,
    morphology, ellipse and Zernike families."""
    return ctx.cached("moment_sums", lambda: moment_power_sums(
        ctx.intens, ctx.mask, ctx.area, ctx.logw))


def _sums_dict(S, dt):
    """{(p, q): [B]} of one plane's [B, 4, 4] sums, in the compute dtype."""
    S = S.to(dt)
    return {(p, q): S[:, p, q] for p in range(4) for q in range(4)}


def moments_all(raw, central, prefix: str, dt, wraw=None, wcentral=None):
    """All moment outputs for one weighting mode.

    raw, central: K10's float64 [B, 4, 4] sums of the weights (INTEN(value)
    * mask, or the mask) around 0 and around their centroid; wraw,
    wcentral: those of the contour-weighted weights (weights * logw, logw
    the host-precomputed log(sqrt(approx_min_d2) + eps) factor, 0 outside
    the mask, from the reference's APPROXIMATE ordered-contour distance
    search, pixel.cpp:36-71), or None: then the weighted (W*) members are
    not emitted (they stay unassigned).  dt: the compute dtype.
    Returns {member_name: [B]}.
    """
    S = _sums_dict(raw, dt)
    C = _sums_dict(central, dt)
    m00 = S[(0, 0)]

    out = {}
    for p, q in RAW_PQ:
        out["%s_RM_%d%d" % (prefix, p, q)] = S[(p, q)]
    for p, q in CENTRAL_PQ:
        out["%s_CM_%d%d" % (prefix, p, q)] = C[(p, q)]

    for p, q in NORM_RAW_PQ:
        k = (p + q) / 2.0 + 1.0
        out["%s_NRM_%d%d" % (prefix, p, q)] = safe_div(
            S[(p, q)], torch.where(m00 > 0, m00, 1) ** k)

    nu = {}
    for p, q in NORM_CENTRAL_PQ:
        k = (p + q) / 2.0 + 1.0
        nu[(p, q)] = safe_div(C[(p, q)], torch.where(m00 > 0, m00, 1) ** k)
        out["%s_NCM_%d%d" % (prefix, p, q)] = nu[(p, q)]

    hu = _hu(nu)
    for i in range(7):
        out["%s_HU%d" % (prefix, i + 1)] = hu[i]

    # ---- weighted moments (distance-to-contour weighting)
    if wraw is not None:
        WS = _sums_dict(wraw, dt)
        WC = _sums_dict(wcentral, dt)
        wm00 = WS[(0, 0)]
        for p, q in W_RAW_PQ:
            out["%s_WRM_%d%d" % (prefix, p, q)] = WS[(p, q)]
        for p, q in W_CENTRAL_PQ:
            out["%s_WCM_%d%d" % (prefix, p, q)] = WC[(p, q)]

        wnu = {}
        for p, q in W_CENTRAL_PQ:
            k = (p + q) / 2.0 + 1.0
            # std::pow(negative, fractional) is NaN -- reproduced by
            # _signed_pow; NaN flows to the soft-NAN substitute at output
            wnu[(p, q)] = WC[(p, q)] / _signed_pow(wm00, k)
            out["%s_WNCM_%d%d" % (prefix, p, q)] = wnu[(p, q)]

        whu = _hu(wnu)
        for i in range(7):
            out["%s_WHU%d" % (prefix, i + 1)] = whu[i]

    return out


def _signed_pow(base, k: float):
    """std::pow semantics: negative base with non-integer exponent -> NaN;
    integer exponent -> exact sign."""
    frac = k != float(int(k))
    ab = torch.abs(base) ** k
    neg = base < 0
    if frac:
        return torch.where(neg, torch.nan, ab)
    odd = int(k) % 2 == 1
    return torch.where(neg & odd, -ab, ab)


def _hu(nu):
    """Hu invariants 1-7 from normalized central moments
    (2d_geomoments_basic.cpp calcHu_imp)."""
    _02, _03, _11, _12 = nu[(0, 2)], nu[(0, 3)], nu[(1, 1)], nu[(1, 2)]
    _20, _21, _30 = nu[(2, 0)], nu[(2, 1)], nu[(3, 0)]
    h1 = _20 + _02
    h2 = (_20 - _02) ** 2 + 4 * _11 ** 2
    h3 = (_30 - 3 * _12) ** 2 + (3 * _21 - _03) ** 2
    h4 = (_30 + _12) ** 2 + (_21 + _03) ** 2
    h5 = ((_30 - 3 * _12) * (_30 + _12) *
          ((_30 + _12) ** 2 - 3 * (_21 + _03) ** 2) +
          (3 * _21 - _03) * (_21 + _03) *
          (3 * (_30 + _12) ** 2 - (_21 + _03) ** 2))
    h6 = ((_20 - _02) * ((_30 + _12) ** 2 - (_21 + _03) ** 2) +
          4 * _11 * (_30 + _12) * (_21 + _03))
    h7 = ((3 * _21 - _03) * (_30 + _12) * ((_30 + _12) ** 2 -
          3 * (_21 + _03) ** 2) - (_30 - 3 * _12) * (_21 + _03) *
          (3 * (_30 + _12) ** 2 - (_21 + _03) ** 2))
    return h1, h2, h3, h4, h5, h6, h7
