"""Zernike polynomial moments (order 9, 30 outputs), batched (PyTorch port
of nyxus_tpu/ops/zernike.py).

Reference: src/nyx/features/zernike.cpp mb_zernike2D: intensity-weighted
Zernike moments over the unit disk of radius N = min(W, H) centered at the
intensity centroid (1-based pixel coordinates), radial polynomials via the
Prata recurrence with precomputed H1/H2/H3 coefficients, outputs
|A_{nm}| = sqrt(AR^2 + AI^2) for (n - m) even, n <= 9.

The 60 sums (AR, AI for 30 (n, m)) and the magnitudes are K12 ``zernike``
(csrc/zernike.cu), written by hand for the card, with a plain PyTorch
version beside it that forms every term as JAX does (the only path for a
tensor on the CPU; a CUDA tensor launches the kernel or raises).  Both accumulate in float64
whatever the compute dtype.  The kernel reads the centroid from K10's power
sums of the masked intensities and writes the magnitudes, the blank
substitution included: one launch a bucket.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from .common import SMS, _check_float, _kernel_device, roi_sizes

ORDER = 9
# float64's machine epsilon, the lower radius bound in both dtypes (JAX's
# jnp.finfo(jnp.float64).eps, zernike.py:59); 2**-52, exact in float32 too
EPS64 = float(np.finfo(np.float64).eps)


def _h_tables(L=ORDER):
    H1 = np.zeros((L + 1, L + 1))
    H2 = np.zeros((L + 1, L + 1))
    H3 = np.zeros((L + 1, L + 1))
    for n_ in range(L + 1):
        for m_ in range(n_ + 1):
            if n_ != m_:
                H3[n_][m_] = -(4.0 * (m_ + 2.0) * (m_ + 1.0)) / ((n_ + m_ + 2.0) * (n_ - m_))
                H2[n_][m_] = (H3[n_][m_] * (n_ + m_ + 4.0) * (n_ - m_ - 2.0)) / (4.0 * (m_ + 3.0)) + (m_ + 2.0)
                H1[n_][m_] = ((m_ + 4.0) * (m_ + 3.0)) / 2.0 - (m_ + 4.0) * H2[n_][m_] \
                    + (H3[n_][m_] * (n_ + m_ + 6.0) * (n_ - m_ - 4.0)) / 8.0
    return H1, H2, H3


_H1, _H2, _H3 = _h_tables()
# the kernel's argument: [3, L + 1, L + 1] float64, H1 then H2 then H3
_H_ALL = np.ascontiguousarray(np.stack([_H1, _H2, _H3]))

# the (n, m) of the 30 outputs, in output order
NM = [(n_, m_) for n_ in range(ORDER + 1) for m_ in range(n_ + 1)
      if (n_ - m_) % 2 == 0]


def zernike_sums_plain(img, cx, cy, rad, s, scale=False):
    """Plain version of K12: JAX's zernike_features (zernike.py:38) term
    for term, without the (n + 1) / pi factors and the sign of AI.

    img: [B, H, W] masked intensities; cx, cy: [B] 1-based centroid; rad:
    [B] min(h, w); s: [B] intensity sum; all of one float dtype.  Returns
    float64 [B, 2, 30]: sum f R_nm cos_m and sum f R_nm sin_m over the
    pixels with eps64 <= r <= 1, f = img / max(s, 1e-30), each term formed
    in the input dtype and summed in float64.  With ``scale`` also the
    float64 [B, 2, 30] sums of the terms' absolute values."""
    B, H, W = img.shape
    dt = img.dtype
    dev = img.device
    xs = torch.arange(1, W + 1, dtype=dt, device=dev)[None, None, :] \
        * torch.ones((1, H, 1), dtype=dt, device=dev)
    ys = torch.arange(1, H + 1, dtype=dt, device=dev)[None, :, None] \
        * torch.ones((1, 1, W), dtype=dt, device=dev)
    x = (xs - cx[:, None, None]) / rad[:, None, None]
    y = (ys - cy[:, None, None]) / rad[:, None, None]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    ok = (r >= EPS64) & (r <= 1.0)
    f = torch.where(ok, img / torch.clamp(s, min=1e-30)[:, None, None], 0.0)

    rs = torch.where(ok, r, 1.0)
    inv_r = 1.0 / rs
    cost = [x * inv_r]
    sint = [y * inv_r]
    for m_ in range(1, ORDER + 1):
        cost.append(cost[0] * cost[-1] - sint[0] * sint[-1])
        sint.append(cost[0] * sint[-1] + sint[0] * cost[m_ - 1])

    R = [torch.ones_like(r)]
    for n_ in range(1, ORDER + 1):
        R.append(rs * R[-1])

    inv_r2 = 1.0 / torch.where(ok, r2, 1.0)

    sums = torch.empty((B, 2, len(NM)), dtype=torch.float64, device=dev)
    absum = torch.empty_like(sums) if scale else None
    k = 0
    for n_ in range(ORDER + 1):
        Rn = R[n_]
        Rnm2 = R[n_ - 2] if n_ >= 2 else None
        Rnmp2 = Rnmp4 = None
        # m descending n, n-2, ...
        rnm_by_m = {}
        for m_ in range(n_, -1, -2):
            if m_ == n_:
                Rnm = Rn
                Rnmp4 = Rn
            elif m_ == n_ - 2:
                Rnm = n_ * Rn - (n_ - 1) * Rnm2
                Rnmp2 = Rnm
            else:
                Rnm = float(_H1[n_][m_]) * Rnmp4 + (
                    float(_H2[n_][m_]) + float(_H3[n_][m_]) * inv_r2) * Rnmp2
                Rnmp4 = Rnmp2
                Rnmp2 = Rnm
            rnm_by_m[m_] = Rnm
        for m_ in range(n_ % 2, n_ + 1, 2):
            fr = f * rnm_by_m[m_]
            for part, trig in ((0, cost[m_]), (1, sint[m_])):
                term = torch.where(ok, fr * trig, 0.0).to(torch.float64)
                sums[:, part, k] = term.sum(dim=(1, 2))
                if scale:
                    absum[:, part, k] = term.abs().sum(dim=(1, 2))
            k += 1
    return (sums, absum) if scale else sums


# K12's launch plan (zernike_plan): pixels a block takes at a time (its
# threads); blocks (a cluster) a ROI at most; the kernel's static shared
# memory (the warps' 64 sums and the block's).  A thread holds 60 float64
# sums, so a block takes an SM's registers (251 a thread in float32, 225
# in float64): more blocks than SMs run in a second wave.
ZK_THREADS = 256
ZK_CLUSTER = 8
ZK_STATIC_SMEM = 8 * (ZK_THREADS // 32 * 64 + 64)


def zernike_plan(B: int, H: int, W: int):
    """(C, chunk) of K12's launch over B crops of H x W: C blocks (a
    thread-block cluster) of ZK_THREADS threads a ROI, block r taking
    pixels [r * chunk, (r + 1) * chunk), chunk a whole number of pixels a
    thread.  As many blocks a ROI as the batch can have in one wave on the
    SMS (a block an SM), at most ZK_CLUSTER and no more than give each
    thread a pixel."""
    A = H * W
    T = ZK_THREADS
    C = max(1, min(ZK_CLUSTER, SMS // max(B, 1), -(-A // T)))
    chunk = -(-A // C)
    chunk = -(-chunk // T) * T
    if A:
        C = -(-A // chunk)
    return C, chunk


def zernike_inputs(raw, heights, widths, dtype):
    """(cx, cy, rad, s) of zernike_sums_plain in ``dtype``, from K10's raw
    power sums of the masked intensities (float64 [B, 4, 4]): the centroid
    S10 / S00 + 1, S01 / S00 + 1 in JAX's 1-based coordinates
    (zernike.py:46-53), rad = min(h, w) and s = S00."""
    s = raw[:, 0, 0]
    den = torch.clamp(s, min=1e-30)
    cx = (raw[:, 1, 0] / den + 1).to(dtype)
    cy = (raw[:, 0, 1] / den + 1).to(dtype)
    rad = torch.minimum(heights, widths).to(dtype)
    return cx, cy, rad, s.to(dtype)


def zernike_moments_plain(img, raw, heights, widths, vmin, vmax, noval,
                          sums=False):
    """Plain version of K12: JAX's zernike_features (zernike.py:38) on the
    masked intensities ``img`` [B, H, W], K10's raw sums ``raw`` of them
    (float64 [B, 4, 4]), the AABB sizes and the ROIs' extrema: the 30
    magnitudes [B, 30] in img's dtype, ``noval`` where vmax == vmin; with
    ``sums`` also zernike_sums_plain's float64 [B, 2, 30]."""
    dt = img.dtype
    S = zernike_sums_plain(img, *zernike_inputs(raw, heights, widths, dt))
    const = torch.tensor([(n_ + 1) / math.pi for n_, _ in NM],
                         dtype=torch.float64, device=img.device)
    ar = const * S[:, 0]
    ai = -(const * S[:, 1])
    vals = torch.sqrt(ar * ar + ai * ai).to(dt)
    blank = (vmax == vmin)[:, None]
    mags = torch.where(blank, torch.tensor(noval, dtype=dt,
                                           device=img.device), vals)
    return (mags, S) if sums else mags


def zernike_moments(img, raw, heights, widths, vmin, vmax, noval,
                    sums=False):
    """K12 zernike (csrc/zernike.cu), replacing
    nyxus_tpu/ops/zernike.py:38 zernike_features: zernike_moments_plain's
    result (see there for the arguments) in one launch, the centroid, the
    sums and the magnitudes formed in the kernel.  A cluster of blocks a
    ROI by zernike_plan, each thread a pixel in turn with the 60 float64
    sums in registers."""
    if not _kernel_device(img, "zernike"):
        return zernike_moments_plain(img, raw, heights, widths, vmin, vmax,
                                     noval, sums)
    _check_float(img, "zernike")
    B = img.shape[0] if img.dim() == 3 else -1
    if B < 0 or raw.shape != (B, 4, 4) or raw.dtype != torch.float64 \
            or any(v.shape != (B,) or v.dtype != img.dtype
                   for v in (vmin, vmax)) \
            or any(t.device != img.device
                   for t in (raw, heights, widths, vmin, vmax)) \
            or heights.shape != (B,) or widths.shape != (B,):
        raise ValueError("zernike: img %s must be [B, H, W] with float64 [B, "
                         "4, 4] sums, [B] sizes and [B] extrema of its dtype "
                         "on its device" % (tuple(img.shape),))
    _, H, W = img.shape
    dt = img.dtype
    mags = torch.empty((B, len(NM)), dtype=dt, device=img.device)
    S = torch.empty((B, 2, len(NM)), dtype=torch.float64,
                    device=img.device) if sums else None
    if B:
        img = img.contiguous()
        if raw.stride(1) != 4 or raw.stride(2) != 1:
            raw = raw.contiguous()
        heights, hs = roi_sizes(heights)
        widths, ws = roi_sizes(widths)
        if vmin.stride(0) != vmax.stride(0):
            vmin, vmax = vmin.contiguous(), vmax.contiguous()
        C, chunk = zernike_plan(B, H, W)
        code = _build.lib().nyx_zernike(
            img.data_ptr(), raw.data_ptr(), raw.stride(0),
            heights.data_ptr(), hs, widths.data_ptr(), ws,
            vmin.data_ptr(), vmax.data_ptr(), vmin.stride(0),
            float(noval), _H_ALL.ctypes.data, mags.data_ptr(),
            None if S is None else S.data_ptr(), B, H, W, C, chunk,
            int(dt == torch.float64), _build.stream_of(img, "zernike"))
        _build.check("zernike", code)
        zernike_moments.launches += 1
    return (mags, S) if sums else mags


zernike_moments.launches = 0


def zernike_features(intens_masked, heights, widths, vmin, vmax,
                     noval: float, dtype, raw):
    """ZERNIKE2D: [B, 30].  ``raw``: K10's float64 [B, 4, 4] raw sums of
    ``intens_masked`` (moments.moment_sums' plane 1)."""
    return {"ZERNIKE2D": zernike_moments(intens_masked.to(dtype), raw,
                                         heights, widths, vmin, vmax, noval)}
