"""NGLDM (neighbouring grey level dependence matrix) features (PyTorch port
of nyxus_tpu/ops/ngldm.py).

Reference: src/nyx/features/ngldm.cpp:81-350.  Uses ROI-membership masking
(in-ROI zero-intensity pixels participate) and ``to_grayscale`` binning
(level = floor(v * n / max), 0-based -- NOT the MATLAB texture binning).
Each ROI pixel contributes at (level, n_matches) with n_matches = number of
ROI 8-neighbors with the same binned level (column j = matches, dependence
count = j + 1).  19 scalar statistics; DCP == 1 by IBSI definition; DCENT
uses the exact log2.

The [B, nmax + 1, 9] matrix is one K4 launch (common.neigh_matrix, mode
"ngldm", the ROI mask as participation).
"""

from __future__ import annotations

import torch

from .common import counted, neigh_matrix, neigh_matrix_plain

NR = 9  # dependencies 0..8 matches

MEMBERS = [
    "NGLDM_LDE", "NGLDM_HDE", "NGLDM_LGLCE", "NGLDM_HGLCE", "NGLDM_LDLGLE",
    "NGLDM_LDHGLE", "NGLDM_HDLGLE", "NGLDM_HDHGLE", "NGLDM_GLNU",
    "NGLDM_GLNUN", "NGLDM_DCNU", "NGLDM_DCNUN", "NGLDM_DCP", "NGLDM_GLM",
    "NGLDM_GLV", "NGLDM_DCM", "NGLDM_DCV", "NGLDM_DCENT", "NGLDM_DCENE",
]


def to_grayscale_levels(intens, vmax, n_levels: int, ibsi: bool):
    """Nyxus::to_grayscale(i, 0, max, n) = floor(i * n / max) (helpers.h:337),
    truncated toward zero like the JAX package's astype(int32): levels
    0..n_levels; IBSI mode keeps the raw levels."""
    if ibsi:
        return intens.to(torch.int32)
    return (intens * n_levels / torch.clamp(vmax, min=1e-30)).to(torch.int32)


def ngldm_features(intens, mask, vmin, vmax, n_levels: int, nmax: int,
                   ibsi: bool, noval: float, dtype):
    """intens: [B, H, W] raw crop; mask: ROI membership; n_levels: the
    to_grayscale level count; nmax: static level cap (levels <= nmax).
    Returns dict member -> [B]."""
    lev = to_grayscale_levels(intens.to(dtype), vmax[:, None, None],
                              n_levels, ibsi)
    P = ngldm_matrix(lev, mask, nmax, dtype)
    return ngldm_features_from_matrix(P, vmin, vmax, noval, dtype)


@counted
def ngldm_matrix(lev, mask, nmax: int, dtype):
    """P: [B, nmax + 1, 9]: each ROI pixel at (level, matches), matches the
    in-ROI neighbours of the same level (JAX: levels -1 outside the ROI,
    matches counted where n_lev >= 0).  One K4 launch on the card,
    ngldm_matrix_plain on the CPU."""
    return neigh_matrix("ngldm", lev, mask, nmax + 1, dtype)


def ngldm_matrix_plain(lev, mask, nmax: int, dtype):
    """Plain version of ngldm_matrix (K4's stencil counts, then K1's pair
    histogram, in plain PyTorch)."""
    return neigh_matrix_plain("ngldm", lev, mask, nmax + 1, dtype)


def ngldm_features_from_matrix(P, vmin, vmax, noval: float, dtype):
    """The 19 statistics from P: [B, nb, 9]."""
    ns = P.sum(dim=(1, 2))
    s = torch.clamp(ns, min=1)
    nb = P.shape[1]
    dev = P.device
    gval = torch.arange(nb, dtype=dtype, device=dev)   # grey level VALUES
    dval = torch.arange(1, NR + 1, dtype=dtype, device=dev)  # counts j+1

    sg = P.sum(dim=2)   # [B, nb]
    sr = P.sum(dim=1)   # [B, NR]
    p = P / s[:, None, None]

    gnz = gval > 0
    g2 = torch.where(gnz, gval * gval, 1)
    inv_g2 = torch.where(gnz, 1 / g2, 0)
    out = {}
    out["NGLDM_LDE"] = (sr / (dval * dval)).sum(dim=1) / s
    out["NGLDM_HDE"] = (sr * dval * dval).sum(dim=1) / s
    out["NGLDM_LGLCE"] = torch.where(gnz, sg / g2, 0).sum(dim=1) / s
    out["NGLDM_HGLCE"] = (sg * gval * gval).sum(dim=1) / s
    out["NGLDM_LDLGLE"] = torch.einsum("bij,i,j->b", P, inv_g2,
                                       1 / (dval * dval)) / s
    out["NGLDM_LDHGLE"] = torch.einsum("bij,i,j->b", P, gval * gval,
                                       1 / (dval * dval)) / s
    out["NGLDM_HDLGLE"] = torch.einsum("bij,i,j->b", P, inv_g2,
                                       dval * dval) / s
    out["NGLDM_HDHGLE"] = torch.einsum("bij,i,j->b", P, gval * gval,
                                       dval * dval) / s
    out["NGLDM_GLNU"] = (sg * sg).sum(dim=1) / s
    out["NGLDM_GLNUN"] = (sg * sg).sum(dim=1) / (s * s)
    out["NGLDM_DCNU"] = (sr * sr).sum(dim=1) / s
    out["NGLDM_DCNUN"] = (sr * sr).sum(dim=1) / (s * s)
    out["NGLDM_DCP"] = torch.ones_like(ns)
    glm = torch.einsum("bij,i->b", p, gval)
    out["NGLDM_GLM"] = glm
    dcm = torch.einsum("bij,j->b", p, dval)
    out["NGLDM_DCM"] = dcm
    out["NGLDM_GLV"] = torch.einsum("bij,bi->b", p,
                                    (gval[None] - glm[:, None]) ** 2)
    out["NGLDM_DCV"] = torch.einsum("bij,bj->b", p,
                                    (dval[None] - dcm[:, None]) ** 2)
    out["NGLDM_DCENT"] = -torch.where(
        p > 0, p * torch.log2(torch.where(p > 0, p, 1)), 0).sum(dim=(1, 2))
    out["NGLDM_DCENE"] = (p * p).sum(dim=(1, 2))

    bad = vmin == vmax
    return {k: torch.where(bad, noval, v) for k, v in out.items()}
