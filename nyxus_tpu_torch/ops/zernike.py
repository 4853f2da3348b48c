"""Zernike polynomial moments (order 9, 30 outputs), batched (PyTorch port
of nyxus_tpu/ops/zernike.py).

Reference: src/nyx/features/zernike.cpp mb_zernike2D: intensity-weighted
Zernike moments over the unit disk of radius N = min(W, H) centered at the
intensity centroid (1-based pixel coordinates), radial polynomials via the
Prata recurrence with precomputed H1/H2/H3 coefficients, outputs
|A_{nm}| = sqrt(AR^2 + AI^2) for (n - m) even, n <= 9.

The 60 sums (AR, AI for 30 (n, m)) are K12 ``zernike`` (csrc/zernike.cu),
written by hand for the card, with a plain PyTorch version beside it that
forms every term as JAX does (the only path for a tensor on the CPU; a
CUDA tensor launches the kernel or raises).  Both accumulate in float64
whatever the compute dtype.  The centroid comes from K10's power sums of
the masked intensities; the (n + 1) / pi factors, the magnitudes and the
blank substitution stay torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from .common import _check_float, _kernel_device
from .moments import power_sums

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


# pixels one K12 block takes on before the wrapper adds another block per
# ROI; at most _MAX_CHUNKS blocks per ROI
_PX_PER_BLOCK = 256
_MAX_CHUNKS = 64


def zernike_sums(img, cx, cy, rad, s):
    """K12 zernike (csrc/zernike.cu), replacing the 60 products and
    reductions of nyxus_tpu/ops/zernike.py:38 zernike_features.  See
    zernike_sums_plain for the arguments and result.  Blocks of ROI x
    chunk, each thread a strip of the crop's nonzero pixels (a zero
    intensity adds nothing) with the 60 float64 sums in registers; a bucket
    above _PX_PER_BLOCK pixels takes several blocks per ROI that add their
    partial sums with double atomics."""
    if not _kernel_device(img, "zernike"):
        return zernike_sums_plain(img, cx, cy, rad, s)
    _check_float(img, "zernike")
    B = img.shape[0] if img.dim() == 3 else -1
    vecs = (cx, cy, rad, s)
    if B < 0 or any(v.shape != (B,) or v.dtype != img.dtype
                    or v.device != img.device for v in vecs):
        raise ValueError("zernike: img %s must be [B, H, W] with [B] "
                         "centroids, radii and sums of its dtype and device"
                         % (tuple(img.shape),))
    img = img.contiguous()
    _, H, W = img.shape
    cx, cy, rad, s = (v.contiguous() for v in vecs)
    chunks = max(1, min(_MAX_CHUNKS, -(-H * W // _PX_PER_BLOCK)))
    alloc = torch.zeros if chunks > 1 else torch.empty
    out = alloc((B, 2, len(NM)), dtype=torch.float64, device=img.device)
    if B == 0 or H * W == 0:
        return out.zero_()
    with torch.cuda.device(img.device):
        code = _build.lib().nyx_zernike(
            img.data_ptr(), cx.data_ptr(), cy.data_ptr(), rad.data_ptr(),
            s.data_ptr(), _H_ALL.ctypes.data, out.data_ptr(), B, H, W,
            chunks, int(img.dtype == torch.float64), _build.stream_of(img))
    _build.check("zernike", code)
    zernike_sums.launches += 1
    return out


zernike_sums.launches = 0


def zernike_inputs(img, heights, widths, raw=None):
    """(cx, cy, rad, s) of zernike_sums, in img's dtype, from K10's raw
    power sums of img (float64 [B, 4, 4], computed when not given): the
    centroid S10 / S00 + 1, S01 / S00 + 1 in JAX's 1-based coordinates
    (zernike.py:46-53), rad = min(h, w) and s = S00."""
    dt = img.dtype
    if raw is None:
        raw = power_sums([img])[:, 0]
    s = raw[:, 0, 0]
    den = torch.clamp(s, min=1e-30)
    cx = (raw[:, 1, 0] / den + 1).to(dt)
    cy = (raw[:, 0, 1] / den + 1).to(dt)
    rad = torch.minimum(heights, widths).to(dt)
    return cx, cy, rad, s.to(dt)


def zernike_features(intens_masked, heights, widths, vmin, vmax,
                     noval: float, dtype, raw=None):
    """ZERNIKE2D: [B, 30].  ``raw``: K10's float64 [B, 4, 4] power sums of
    ``intens_masked`` when the caller has them (the intensity moments share
    that launch)."""
    img = intens_masked.to(dtype)
    cx, cy, rad, s = zernike_inputs(img, heights, widths, raw)
    S = zernike_sums(img, cx, cy, rad, s)
    const = torch.tensor([(n_ + 1) / math.pi for n_, _ in NM],
                         dtype=torch.float64, device=img.device)
    ar = const * S[:, 0]
    ai = -(const * S[:, 1])
    vals = torch.sqrt(ar * ar + ai * ai).to(dtype)
    blank = (vmax == vmin)[:, None]
    return {"ZERNIKE2D": torch.where(
        blank, torch.tensor(noval, dtype=dtype, device=img.device), vals)}
