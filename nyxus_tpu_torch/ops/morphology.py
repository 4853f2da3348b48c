"""Basic morphology + ellipse-fitting features, batched (PyTorch port of
nyxus_tpu/ops/morphology.py).

Reference: src/nyx/features/basic_morphology.cpp:16-70,
ellipse_fitting.cpp:20-65.

The coordinate sums (centroid, weighted centroid, the ellipse's centred
second moments) come from K10 in AABB-local coordinates
(``moments.moment_sums``, one launch a batch shared with the moment and
Zernike families): the centroid is ``x0 + sum(m * x_local) / n``, the
value of JAX's global-coordinate sum up to rounding.  COMPACTNESS's
distance spread and the closed forms stay torch.
"""

from __future__ import annotations

import math

import torch

from .common import safe_div
from .moments import moment_sums


def local_grids(ctx):
    """AABB-local coordinate grids [1, H, W] (x = col, y = row) in the
    compute dtype."""
    H, W = ctx.shape
    dt = ctx.intens.dtype
    dev = ctx.intens.device
    xs = torch.arange(W, dtype=dt, device=dev)[None, None, :]
    ys = torch.arange(H, dtype=dt, device=dev)[None, :, None]
    return xs, ys


def mask_intensity_sums(ctx):
    """K10's raw sums of the mask and the masked intensity planes:
    float64 [B, 2, 4, 4]."""
    return moment_sums(ctx).raw[:, :2]


def local_centroid(ctx):
    """(cx, cy) AABB-local centroid over the aux_area count n, [B] each
    (K10's ellipse centre)."""
    c = moment_sums(ctx).centres[:, -1]
    return c[:, 0], c[:, 1]


def basic_morphology(ctx, cfg):
    dt = ctx.intens.dtype
    m = ctx.mask
    n = ctx.area.to(dt)
    x0 = ctx.x0.to(dt)
    y0 = ctx.y0.to(dt)
    sums = mask_intensity_sums(ctx).to(dt)
    lcx, lcy = local_centroid(ctx)
    # the centroid sums the k fed pixels' slide coordinates over n: x0 k / n
    # plus the local centroid, x0 + lcx exactly where k == n (k != n only
    # under anisotropy)
    k = sums[:, 0, 0, 0]
    cx = x0 * (k / n) + lcx
    cy = y0 * (k / n) + lcy

    # COMPACTNESS = Moments2(dist to centroid).std / n: the Moments2 object
    # counts the FED pixels (k = raw_pixels.size(), moments.h:14-39) while
    # the final division uses aux_area n (basic_morphology.cpp:50-58);
    # k != n only under anisotropy (virtual resampling)
    xs, ys = local_grids(ctx)
    sx = (x0 - cx + lcx)[:, None, None]     # 0 where k == n
    sy = (y0 - cy + lcy)[:, None, None]
    dx = torch.where(m, xs - lcx[:, None, None] + sx, 0)
    dy = torch.where(m, ys - lcy[:, None, None] + sy, 0)
    dist = torch.sqrt(dx * dx + dy * dy)
    dmean = torch.where(m, dist, 0).sum(dim=(1, 2)) / torch.clamp(k, min=1)
    m2 = torch.where(m, (dist - dmean[:, None, None]) ** 2, 0).sum(dim=(1, 2))
    dstd = torch.where(k > 2, torch.sqrt(m2 / torch.clamp(k - 1, min=1)), 0.0)
    compactness = dstd / n

    mass = sums[:, 1, 0, 0]
    wcx = x0 + safe_div(sums[:, 1, 1, 0], mass)
    wcy = y0 + safe_div(sums[:, 1, 0, 1], mass)
    mass_disp = torch.sqrt((wcx - cx) ** 2 + (wcy - cy) ** 2)
    mass_disp = torch.where(mass > 0, mass_disp,
                            torch.sqrt(cx * cx + cy * cy))  # wc=(0,0) if mass==0

    hw = ctx.heights.to(dt)
    ww = ctx.widths.to(dt)

    out = {
        "AREA_PIXELS_COUNT": n,
        "DIAMETER_EQUAL_AREA": 2.0 * torch.sqrt(n / math.pi),
        "BBOX_XMIN": x0,
        "BBOX_YMIN": y0,
        "BBOX_WIDTH": ww,
        "BBOX_HEIGHT": hw,
        "CENTROID_X": cx,
        "CENTROID_Y": cy,
        "COMPACTNESS": compactness,
        "WEIGHTED_CENTROID_X": torch.where(mass > 0, wcx, 0.0),
        "WEIGHTED_CENTROID_Y": torch.where(mass > 0, wcy, 0.0),
        "MASS_DISPLACEMENT": mass_disp,
        "EXTENT": n / (hw * ww),
        "ASPECT_RATIO": ww / hw,
    }
    # AREA_UM2: basic_morphology.cpp:23-28 gates on the Fsettings XYRES slot,
    # but Environment::refresh_feature_settings (env_features.cpp:711-737)
    # never populates that slot -- only PIXELSIZEUM -- so the reference
    # binary emits the fvals default 0 for every ROI regardless of
    # --pixelsPerCentimeter / pixels_per_micron.  Mirror that: always
    # unassigned.
    out["AREA_UM2"] = torch.full_like(n, -0.0)
    return out


def ellipse_fitting(ctx, cfg):
    """EllipseFittingFeature (ellipse_fitting.cpp:20-65)."""
    dt = ctx.intens.dtype
    n = ctx.area.to(dt)
    # second moments normalize by the FED pixel count k = raw_pixels.size()
    # (ellipse_fitting.cpp:47-50), around the aux_area-based centroid
    k0 = mask_intensity_sums(ctx)[:, 0, 0, 0].to(dt)
    k = torch.clamp(k0, min=1)
    C = moment_sums(ctx).ellipse.to(dt)
    # K10 centres the sums at the local centroid; the reference's centre
    # sits x0 (1 - k / n) before it in local coordinates, which is 0 where
    # k == n (k != n only under anisotropy): move the centre by d
    shift = torch.where(k0 > 0, k / n - 1, 0.0)
    dx = ctx.x0.to(dt) * shift
    dy = ctx.y0.to(dt) * shift
    uxx = (C[:, 2, 0] - 2 * dx * C[:, 1, 0] + k * dx * dx) / k + 1.0 / 12.0
    uyy = (C[:, 0, 2] - 2 * dy * C[:, 0, 1] + k * dy * dy) / k + 1.0 / 12.0
    uxy = (C[:, 1, 1] - dx * C[:, 0, 1] - dy * C[:, 1, 0] + k * dx * dy) / k

    common = torch.sqrt((uxx - uyy) ** 2 + 4.0 * uxy * uxy)
    major = 2.0 * math.sqrt(2.0) * torch.sqrt(uxx + uyy + common)
    minor = 2.0 * math.sqrt(2.0) * torch.sqrt(
        torch.clamp(uxx + uyy - common, min=0))
    ecc = torch.sqrt(1.0 - (minor * minor) / (major * major))
    elong = minor / major
    roundness = (4.0 * n) / (math.pi * major * major)

    num = torch.where(uyy > uxx,
                      uyy - uxx + torch.sqrt((uyy - uxx) ** 2 + 4 * uxy * uxy),
                      2 * uxy)
    den = torch.where(uyy > uxx, 2 * uxy,
                      uxx - uyy + torch.sqrt((uxx - uyy) ** 2
                                             + 4 * uxy * uxy))
    orient = torch.where(
        uxy == 0.0,
        torch.where(uxx >= uyy, 0.0, 90.0),
        180.0 / math.pi * torch.atan(safe_div(num, den)))

    return {
        "MAJOR_AXIS_LENGTH": major,
        "MINOR_AXIS_LENGTH": minor,
        "ECCENTRICITY": ecc,
        "ELONGATION": elong,
        "ORIENTATION": orient,
        "ROUNDNESS": roundness,
    }
