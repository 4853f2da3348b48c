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

N, S and the present-level set are one K4 launch (common.neigh_matrix,
mode "ngtdm"): the neighbourhood sums and the three per-level histograms.
"""

from __future__ import annotations

import torch

from .common import counted, neigh_matrix, neigh_matrix_plain

MEMBERS = ["NGTDM_COARSENESS", "NGTDM_CONTRAST", "NGTDM_BUSYNESS",
           "NGTDM_COMPLEXITY", "NGTDM_STRENGTH"]


@counted
def ngtdm_matrices(levels, valid, nmax: int, dtype):
    """(N, S, present), each [B, nmax + 1]: per-level zone counts, sums of
    |level - neighbourhood mean|, and which non-zero levels occur in the
    valid area.  One K4 launch on the card, ngtdm_matrices_plain on the
    CPU."""
    return neigh_matrix("ngtdm", levels, valid, nmax + 1, dtype)


def ngtdm_matrices_plain(levels, valid, nmax: int, dtype):
    """Plain version of ngtdm_matrices (K4's stencil sums, then one K1
    histogram of three channels, in plain PyTorch)."""
    return neigh_matrix_plain("ngtdm", levels, valid, nmax + 1, dtype)


def ngtdm_features(levels, valid, nmax: int, vmin, vmax, noval: float, dtype,
                   ibsi: bool = False):
    """levels: [B, H, W] int binned levels; valid: participation mask
    (AABB for MATLAB binning, AABB & level>0 otherwise); nmax: static level
    cap (levels <= nmax); ``ibsi``: raw levels (IBSI's degenerate gate).
    Returns dict member -> [B]."""
    N, S, present = ngtdm_matrices(levels, valid, nmax, dtype)
    return ngtdm_stats_chunked(N, S, present, levels, valid, noval, dtype,
                               ibsi)


# bytes of one [B, nb, nb] temporary of ngtdm_stats per chunk of ROIs
_CHUNK_BYTES = 1 << 28


def ngtdm_stats_chunked(N, S, present, levels, valid, noval: float, dtype,
                        ibsi: bool):
    """ngtdm_stats over chunks of ROIs: its [B, nb, nb] temporaries reach
    4097^2 a ROI at raw 12-bit levels."""
    B, nb = N.shape
    step = max(1, _CHUNK_BYTES // (nb * nb * 8))
    if step >= B:
        return ngtdm_stats(N, S, present, levels, valid, noval, dtype, ibsi)
    parts = [ngtdm_stats(N[c:c + step], S[c:c + step], present[c:c + step],
                         levels[c:c + step], valid[c:c + step], noval, dtype,
                         ibsi)
             for c in range(0, B, step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def ngtdm_stats(N, S, present, levels, valid, noval: float, dtype,
                ibsi: bool = False):
    """The 5 NGTDM statistics from per-level counts N and diff sums S
    (nyxus_tpu/ops/ngtdm.py:61), shared by the 2D and 3D builders.
    levels/valid ([B, ...]) serve only the IBSI degenerate gate: with
    ``ibsi`` a ROI is degenerate when its largest valid level is below 1
    (the reference's I = 0..max has fewer than two entries), else when
    fewer than two distinct non-zero levels are present."""
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
    if ibsi:
        B = N.shape[0]
        maxlev = torch.where(valid, levels, 0).reshape(B, -1).amax(dim=1)
        degenerate = maxlev < 1
    else:
        degenerate = ngp < 2
    return {k: torch.where(degenerate, noval, v) for k, v in out.items()}
