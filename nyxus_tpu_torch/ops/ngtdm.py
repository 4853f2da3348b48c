"""NGTDM (neighbourhood grey tone difference matrix) features (PyTorch port
of nyxus_tpu/ops/ngtdm.py).

Reference: src/nyx/features/ngtdm.cpp:40-330.  For every non-zero-level pixel
with at least one non-zero-level 8-neighbor, record (level, mean of non-zero
neighbor levels); accumulate per-level counts N and absolute differences
S = sum |level - neighborhood mean|; 5 scalar statistics follow.

Faithful notes:
* MATLAB binning maps original 0 -> level 1 (texture_feature.h), so AABB
  background participates as level 1
* degenerate gate: fewer than 2 distinct non-zero levels -> all soft-NAN
  (ngtdm.cpp:76-84)
* Ngp = number of distinct non-zero levels over the whole (binned) AABB

The neighbourhood sums are K4 (common.stencil8); N, S and the present-level
set are K1 histograms (common.masked_bincount).
"""

from __future__ import annotations

import torch

from .common import masked_bincount, stencil8

MEMBERS = ["NGTDM_COARSENESS", "NGTDM_CONTRAST", "NGTDM_BUSYNESS",
           "NGTDM_COMPLEXITY", "NGTDM_STRENGTH"]


def ngtdm_matrices(levels, valid, nmax: int, dtype):
    """(N, S, present), each [B, nmax + 1]: per-level zone counts, sums of
    |level - neighbourhood mean|, and which non-zero levels occur in the
    valid area."""
    B = levels.shape[0]
    lev = torch.where(valid, levels.to(torch.int32), 0)
    _, nsum, ncnt = stencil8(lev, valid)
    is_zone = (lev > 0) & (ncnt > 0)
    ave = torch.where(is_zone,
                      nsum.to(dtype) / torch.clamp(ncnt, min=1).to(dtype), 0)

    nb = nmax + 1
    flat_lev = lev.reshape(B, -1)
    wzone = is_zone.reshape(B, -1).to(dtype)
    N = masked_bincount(flat_lev, wzone, nb)                     # [B, nb]
    diff = torch.abs(lev.to(dtype) - ave).reshape(B, -1)
    S = masked_bincount(flat_lev, wzone * diff, nb)
    present = masked_bincount(flat_lev, valid.reshape(B, -1).to(dtype), nb) > 0
    present[:, 0] = False
    return N, S, present


def ngtdm_features(levels, valid, nmax: int, vmin, vmax, noval: float, dtype):
    """levels: [B, H, W] int binned levels; valid: participation mask
    (AABB for MATLAB binning, AABB & level>0 otherwise); nmax: static level
    cap (levels <= nmax).  Returns dict member -> [B]."""
    N, S, present = ngtdm_matrices(levels, valid, nmax, dtype)
    return ngtdm_stats(N, S, present, noval, dtype)


def ngtdm_stats(N, S, present, noval: float, dtype):
    """The 5 NGTDM statistics from per-level counts N and diff sums S."""
    B, nb = N.shape
    ngp = present.sum(dim=1).to(dtype)                           # Ngp

    nvc = N.sum(dim=1)                                           # = Nvp
    P = N / torch.clamp(nvc[:, None], min=1)

    ival = torch.arange(nb, dtype=dtype, device=N.device)        # level values

    coarseness = 1.0 / (P * S).sum(dim=1)

    dij2 = (ival[:, None] - ival[None, :]) ** 2
    pp = P[:, :, None] * P[:, None, :]
    ngp_p2 = torch.where(ngp > 1, ngp * (ngp - 1), torch.clamp(ngp, min=1))
    term1 = (pp * dij2).sum(dim=(1, 2)) / ngp_p2
    term2 = S.sum(dim=1) / torch.clamp(nvc, min=1)
    contrast = term1 * term2

    both = (P[:, :, None] != 0) & (P[:, None, :] != 0)
    pi_i = P * ival
    busy_den = torch.where(both, torch.abs(pi_i[:, :, None] - pi_i[:, None, :]),
                           0).sum(dim=(1, 2))
    busy_num = (P * S).sum(dim=1)
    busyness = torch.where((ngp == 1) | (busy_den == 0), 0.0,
                           busy_num / torch.where(busy_den == 0, 1, busy_den))

    ps = P * S
    num_c = torch.abs(ival[:, None] - ival[None, :]) * (
        ps[:, :, None] + ps[:, None, :])
    den_c = P[:, :, None] + P[:, None, :]
    complexity = torch.where(both, num_c / torch.where(both, den_c, 1),
                             0).sum(dim=(1, 2)) / torch.clamp(nvc, min=1)

    strength_num = torch.where(both, (P[:, :, None] + P[:, None, :]) * dij2,
                               0).sum(dim=(1, 2))
    strength = strength_num / S.sum(dim=1)

    out = {
        "NGTDM_COARSENESS": coarseness,
        "NGTDM_CONTRAST": contrast,
        "NGTDM_BUSYNESS": busyness,
        "NGTDM_COMPLEXITY": complexity,
        "NGTDM_STRENGTH": strength,
    }
    degenerate = ngp < 2
    return {k: torch.where(degenerate, noval, v) for k, v in out.items()}
