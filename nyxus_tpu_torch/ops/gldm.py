"""GLDM (grey-level dependence matrix) features (PyTorch port of
nyxus_tpu/ops/gldm.py).

Reference: src/nyx/features/gldm.cpp:53-700.  Each ROI pixel (original
intensity != 0) contributes one entry at (level, nd) where nd = 1 + number of
8-neighbors that are ROI pixels with the same binned level.  14 scalar
statistics over P[level, nd].

Background is excluded by ORIGINAL intensity for both center and neighbors
(gldm.cpp:116-124), unlike GLRLM/NGTDM.  Blank ROI (min == max) -> soft-NAN.
The matrix is one K4 launch (common.neigh_matrix, mode "gldm").
"""

from __future__ import annotations

import torch

from .common import counted, fast_log2, neigh_matrix, neigh_matrix_plain

EPS = 2.2e-16  # reference: glrlm.h:169 / glszm.h:138 / gldm.h:105

MEMBERS = [
    "GLDM_SDE", "GLDM_LDE", "GLDM_GLN", "GLDM_DN", "GLDM_DNN", "GLDM_GLV",
    "GLDM_DV", "GLDM_DE", "GLDM_LGLE", "GLDM_HGLE", "GLDM_SDLGLE",
    "GLDM_SDHGLE", "GLDM_LDLGLE", "GLDM_LDHGLE",
]


@counted
def gldm_matrix(orig, levels, ng: int, dtype):
    """P: [B, ng, 9] dependence counts (dependencies 1..9).  orig: masked original intensities
    (0 = background); levels: binned levels (1-based).  One K4 launch on
    the card, gldm_matrix_plain on the CPU."""
    return neigh_matrix("gldm", levels, orig, ng, dtype)


def gldm_matrix_plain(orig, levels, ng: int, dtype):
    """Plain version of gldm_matrix (K4's stencil counts, then K1's pair
    histogram, in plain PyTorch)."""
    return neigh_matrix_plain("gldm", levels, orig, ng, dtype)


def gldm_features(P, vmin, vmax, noval: float):
    """14 members from P: [B, ng, 9]."""
    dtype = P.dtype
    B, ng, nd = P.shape
    dev = P.device
    nz = P.sum(dim=(1, 2))
    s = torch.clamp(nz, min=1)

    ival = torch.arange(1, ng + 1, dtype=dtype, device=dev)
    jval = torch.arange(1, nd + 1, dtype=dtype, device=dev)
    si = P.sum(dim=2)          # [B, ng]
    sj = P.sum(dim=1)          # [B, nd]

    out = {}
    out["GLDM_SDE"] = (sj / (jval * jval)).sum(dim=1) / s
    out["GLDM_LDE"] = (sj * (jval * jval)).sum(dim=1) / s
    out["GLDM_GLN"] = (si * si).sum(dim=1) / s
    out["GLDM_DN"] = (sj * sj).sum(dim=1) / s
    out["GLDM_DNN"] = (sj * sj).sum(dim=1) / (s * s)
    mu = (si * ival).sum(dim=1) / s
    out["GLDM_GLV"] = (si * (ival - mu[:, None]) ** 2).sum(dim=1) / s
    mud = (sj * jval).sum(dim=1) / s
    out["GLDM_DV"] = (sj * (jval - mud[:, None]) ** 2).sum(dim=1) / s
    p = P / s[:, None, None]
    out["GLDM_DE"] = -(p * fast_log2(p + EPS)).sum(dim=(1, 2))
    i2 = ival * ival
    j2 = jval * jval
    out["GLDM_LGLE"] = (si / i2).sum(dim=1) / s
    out["GLDM_HGLE"] = (si * i2).sum(dim=1) / s
    out["GLDM_SDLGLE"] = torch.einsum("bij,i,j->b", P, 1 / i2, 1 / j2) / s
    out["GLDM_SDHGLE"] = torch.einsum("bij,i,j->b", P, i2, 1 / j2) / s
    out["GLDM_LDLGLE"] = torch.einsum("bij,i,j->b", P, 1 / i2, j2) / s
    out["GLDM_LDHGLE"] = torch.einsum("bij,i,j->b", P, i2, j2) / s

    bad = (vmin == vmax) | (nz == 0)
    return {k: torch.where(bad, noval, v) for k, v in out.items()}
