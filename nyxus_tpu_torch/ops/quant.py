"""Texture grey-level binning (PyTorch port of nyxus_tpu/ops/quant.py).

Three modes, selected by the SIGN of the grey-depth setting
(reference: src/nyx/features/texture_feature.h:78-198):

* ``greyinfo > 0``  MATLAB binning (1-based): slope = n/max, intercept = 1,
  y = clamp(floor(slope*x + 1), 1, n), with x == 0 -> 1
* ``greyinfo < 0``  radiomics binning (1-based): binW = (max-min)/|n|,
  y = min(floor((x-min)/binW) + 1, n), with x == 0 -> 0
* ``greyinfo == 0`` IBSI: no binning, raw intensities

Each product and sum below is its own eager PyTorch op, so nothing is
contracted into an FMA (the reference rounds the product first).
"""

from __future__ import annotations

import torch


def _floor_ratio_exact(num, den):
    """floor(num / den) computed EXACTLY for f32 inputs whose products fit
    the 24-bit mantissa: a correctly-rounded divide followed by one integer
    remainder correction (see the JAX package for the derivation)."""
    d = torch.clamp(den, min=1e-30)
    q = torch.floor(num / d)
    r = num - q * d
    q = torch.where(r < 0, q - 1, q)
    q = torch.where(r >= d, q + 1, q)
    return q


def bin_matlab(x, vmax, n_levels: int):
    """MATLAB-style binning. x: float tensor; vmax: per-ROI max
    (broadcastable).  Returns int32 levels in 1..n_levels (x == 0 -> 1).
    f32 uses the exact integer ratio; f64 is ``floor(slope * x) + 1``."""
    if x.dtype == torch.float32:
        y = (_floor_ratio_exact(n_levels * x, vmax) + 1.0).to(torch.int32)
    else:
        slope = n_levels / torch.clamp(vmax, min=1e-30)
        y = (torch.floor(slope * x) + 1.0).to(torch.int32)
    y = torch.clamp(y, 1, n_levels)
    return torch.where(x == 0, 1, y)


def bin_radiomics(x, vmin, vmax, n_levels: int):
    """Radiomics-style binning. Returns int32 levels in 1..n (x == 0 -> 0);
    the last bin is one unit wider."""
    if x.dtype == torch.float32:
        y = (_floor_ratio_exact((x - vmin) * n_levels, vmax - vmin)
             + 1.0).to(torch.int32)
    else:
        binw = (vmax - vmin) / n_levels
        y = (torch.floor((x - vmin) / torch.clamp(binw, min=1e-30))
             + 1).to(torch.int32)
    y = torch.clamp(y, max=n_levels)
    return torch.where(x == 0, 0, y)


def bin_levels(x, vmin, vmax, greyinfo: int):
    """Dispatch on the sign of greyinfo like TextureFeature::bin_pixel."""
    if greyinfo > 0:
        return bin_matlab(x, vmax, greyinfo)
    if greyinfo < 0:
        return bin_radiomics(x, vmin, vmax, -greyinfo)
    return x.to(torch.int32)  # IBSI: raw


def binned_range_degenerate(vmin, vmax, greyinfo: int):
    """True where bin(min) == bin(max): the whole family emits soft-NAN
    (reference: glcm.cpp:27-97)."""
    lo = bin_levels(vmin, vmin, vmax, greyinfo)
    hi = bin_levels(vmax, vmin, vmax, greyinfo)
    return lo == hi
