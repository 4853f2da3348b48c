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
for the card, with a plain PyTorch version beside it that forms every term
as JAX does (the only path for a tensor on the CPU; a CUDA tensor launches
the kernel or raises).  Both accumulate in float64 whatever the compute
dtype.  The normalisations, Hu invariants and the signed powers stay torch.
"""

from __future__ import annotations

import torch

from .. import _build
from .common import _kernel_device, safe_div

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

# pixels a block of K10 takes on before the wrapper adds another block per
# (ROI, plane); at most _MAX_CHUNKS blocks per (ROI, plane)
_PX_PER_BLOCK = 4096
_MAX_CHUNKS = 64


def _check_planes(planes, centre):
    w = planes[0]
    if w.dim() != 3 or not 1 <= len(planes) <= 2:
        raise ValueError("power_sums: one or two [B, H, W] planes expected")
    if w.dtype not in (torch.float32, torch.float64):
        raise TypeError("power_sums: float32 or float64 expected, got %s"
                        % w.dtype)
    for p in planes[1:]:
        if p.shape != w.shape or p.dtype != w.dtype or p.device != w.device:
            raise ValueError("power_sums: planes %s and %s differ"
                             % (tuple(w.shape), tuple(p.shape)))
    if centre is not None and (centre.shape != (w.shape[0], len(planes), 2)
                               or centre.device != w.device):
        raise ValueError("power_sums: centre %s must be [B, P, 2]"
                         % (tuple(centre.shape),))


def power_sums_plain(planes, centre=None):
    """Plain version of K10: JAX's _power_sums (moments.py:36) for each
    plane, the sum taken in float64.  planes: list of one or two [B, H, W]
    weight planes; centre: None or [B, P, 2] (ox, oy) per plane ->
    float64 [B, P, 4, 4], S[b, p, i, j] = sum w_p (x - ox)^i (y - oy)^j."""
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


def power_sums(planes, centre=None):
    """K10 power_sums (csrc/power_sums.cu), replacing
    nyxus_tpu/ops/moments.py:36 _power_sums and the coordinate sums of
    nyxus_tpu/ops/morphology.py.  See power_sums_plain for the arguments;
    returns float64 [B, P, 4, 4].  Blocks of (ROI, plane) x chunk, each
    thread a strip of pixels, float64 accumulation; a bucket above
    _PX_PER_BLOCK pixels takes several blocks per (ROI, plane) that add
    their partial sums with double atomics."""
    planes = list(planes)
    if not _kernel_device(planes[0], "power_sums"):
        return power_sums_plain(planes, centre)
    _check_planes(planes, centre)
    planes = [p.contiguous() for p in planes]
    w0 = planes[0]
    B, H, W = w0.shape
    P = len(planes)
    if centre is not None:
        centre = centre.to(w0.dtype).contiguous()
    chunks = max(1, min(_MAX_CHUNKS, -(-H * W // _PX_PER_BLOCK)))
    alloc = torch.zeros if chunks > 1 else torch.empty
    out = alloc((B, P, 4, 4), dtype=torch.float64, device=w0.device)
    if B == 0 or H * W == 0:
        return out.zero_()
    with torch.cuda.device(w0.device):
        code = _build.lib().nyx_power_sums(
            w0.data_ptr(), planes[1].data_ptr() if P > 1 else None,
            None if centre is None else centre.data_ptr(), out.data_ptr(),
            B, P, H, W, chunks, int(w0.dtype == torch.float64),
            _build.stream_of(w0))
    _build.check("power_sums", code)
    power_sums.launches += 1
    return out


power_sums.launches = 0


def _sums_dict(S, dt):
    """{(p, q): [B]} of one plane's [B, 4, 4] sums, in the compute dtype."""
    S = S.to(dt)
    return {(p, q): S[:, p, q] for p in range(4) for q in range(4)}


def moment_planes(weights, logw=None):
    """K10's weight planes of one weighting mode: the weights, and the
    contour-weighted weights * logw when logw is given."""
    if logw is None:
        return [weights]
    return [weights, weights * logw.to(weights.dtype)]


def moments_all(ctx, weights, prefix: str, logw=None, raw=None):
    """All moment outputs for one weighting mode.

    weights: [B, H, W] INTEN(value) * mask (intensity or ones).
    logw: [B, H, W] host-precomputed log(sqrt(approx_min_d2) + eps) factor
    (0 outside the mask), using the reference's APPROXIMATE ordered-contour
    distance search (pixel.cpp:36-71).  If None the weighted (W*) members
    are not emitted (they stay unassigned).
    raw: the raw power sums of moment_planes(weights, logw) when the caller
    has them (Zernike shares the intensity moments' launch).
    Returns {member_name: [B]}.
    """
    dt = weights.dtype
    planes = moment_planes(weights, logw)
    if raw is None:
        raw = power_sums(planes)
    S = _sums_dict(raw[:, 0], dt)

    out = {}

    # ---- plain moments
    m00 = S[(0, 0)]
    ox = safe_div(S[(1, 0)], m00)
    oy = safe_div(S[(0, 1)], m00)
    centres = [torch.stack([ox, oy], dim=1)]
    if logw is not None:
        WS = _sums_dict(raw[:, 1], dt)
        wm00 = WS[(0, 0)]
        wox = safe_div(WS[(1, 0)], wm00)
        woy = safe_div(WS[(0, 1)], wm00)
        centres.append(torch.stack([wox, woy], dim=1))
    # central sums of both planes around their own centres: one more launch
    central = power_sums(planes, torch.stack(centres, dim=1))
    C = _sums_dict(central[:, 0], dt)

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
    if logw is not None:
        WC = _sums_dict(central[:, 1], dt)
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
