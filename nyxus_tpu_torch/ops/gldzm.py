"""GLDZM (grey-level distance-zone matrix) features (PyTorch port of
nyxus_tpu/ops/gldzm.py).

Reference: src/nyx/features/gldzm.cpp:55-470.  A GLDZM zone is a full
4-connected same-level component (E/S/W/N DFS, gldzm.cpp:121-210); each
zone's metric is the minimum over its pixels of ``dist2border`` -- 1 + the
number of steps along a row/column to the nearest zero-level pixel or to the
AABB margin (whichever is nearer), where a pixel sitting on the margin has
distance 1 (gldzm.cpp:306-352).  The labels and distances are one launch of
K6 (ops/zones.zone_cc4), the per-zone list K7 (ops/zones.zone_list).

Faithful notes:
* MATLAB binning has no zero levels (background -> level 1), so the distance
  reduces to the distance to the AABB margin
* Ns (normalizer) counts zones with non-zero grey level; ZP = Ns / roi_area;
  GLE == ZDE (gldzm.cpp:418-421); ZDE uses the exact log2
* blank ROI (min == max) -> all members soft-NAN
"""

from __future__ import annotations

import torch

from . import zones
from .common import counted
from .glszm import _grouped_square_sum, _inv

EPS = 2.2e-16  # gldzm.h:68

MEMBERS = [
    "GLDZM_SDE", "GLDZM_LDE", "GLDZM_LGLZE", "GLDZM_HGLZE", "GLDZM_SDLGLE",
    "GLDZM_SDHGLE", "GLDZM_LDLGLE", "GLDZM_LDHGLE", "GLDZM_GLNU",
    "GLDZM_GLNUN", "GLDZM_ZDNU", "GLDZM_ZDNUN", "GLDZM_ZP", "GLDZM_GLM",
    "GLDZM_GLV", "GLDZM_ZDM", "GLDZM_ZDV", "GLDZM_ZDE",
]


def gldzm_features(levels, valid, heights, widths, roi_area, vmin, vmax,
                   noval: float, dtype):
    """levels/valid as in GLSZM; roi_area: [B] ROI pixel count (Nv).
    Returns dict member -> [B]."""
    B, H, W = levels.shape
    anc, dist = zones.zone_cc4(levels, valid, heights, widths)
    zlev_i, _, zd_i, ok = zones.zone_list(anc, levels, valid, dist=dist)
    zlev = zlev_i.to(dtype)
    zd = zd_i.to(dtype)
    wz = (ok & (zlev_i > 0)).to(dtype)   # non-zero grey zones count to Ns
    return gldzm_features_from_zones(zlev, zd, wz, roi_area, vmin, vmax,
                                     noval, dtype, H + W + 2)


@counted
def gldzm_features_from_zones(zlev, zd, wz, roi_area, vmin, vmax,
                              noval: float, dtype, maxd: int):
    """The 18 statistics from per-zone (level, min border distance) lists.

    zlev/zd: [B, Z] zone grey level and distance (0 where wz == 0); wz:
    [B, Z] 1.0 at counted zones (non-zero grey); maxd: any integer > max
    distance (ZDE cell key stride)."""
    ns = wz.sum(dim=1)
    s = torch.clamp(ns, min=1)
    g2 = zlev * zlev
    d2 = zd * zd

    out = {}
    out["GLDZM_SDE"] = (wz * _inv(d2)).sum(dim=1) / s
    out["GLDZM_LDE"] = (wz * d2).sum(dim=1) / s
    out["GLDZM_LGLZE"] = (wz * _inv(g2)).sum(dim=1) / s
    out["GLDZM_HGLZE"] = (wz * g2).sum(dim=1) / s
    out["GLDZM_SDLGLE"] = (wz * _inv(g2) * _inv(d2)).sum(dim=1) / s
    out["GLDZM_SDHGLE"] = (wz * g2 * _inv(d2)).sum(dim=1) / s
    out["GLDZM_LDLGLE"] = (wz * d2 * _inv(g2)).sum(dim=1) / s
    out["GLDZM_LDHGLE"] = (wz * g2 * d2).sum(dim=1) / s

    inf = torch.tensor(float("inf"), dtype=dtype, device=wz.device)
    # GLNU: zones grouped by level; ZDNU: by distance (counted zones only)
    glnu = _grouped_square_sum(torch.where(wz > 0, zlev, inf), wz, dtype)
    out["GLDZM_GLNU"] = glnu / s
    out["GLDZM_GLNUN"] = glnu / (s * s)
    zdnu = _grouped_square_sum(torch.where(wz > 0, zd, inf), wz, dtype)
    out["GLDZM_ZDNU"] = zdnu / s
    out["GLDZM_ZDNUN"] = zdnu / (s * s)

    out["GLDZM_ZP"] = ns / torch.clamp(roi_area.to(dtype), min=1)
    glm = (wz * zlev).sum(dim=1) / s
    out["GLDZM_GLM"] = glm
    zdm = (wz * zd).sum(dim=1) / s
    out["GLDZM_ZDM"] = zdm
    out["GLDZM_GLV"] = (wz * (zlev - glm[:, None]) ** 2).sum(dim=1) / s
    out["GLDZM_ZDV"] = (wz * (zd - zdm[:, None]) ** 2).sum(dim=1) / s

    # ZDE over (level, distance) cells: each row contributes
    # w * log2(p_cell), p_cell = (cell weight sum)/Ns
    _, wc, sum_c, v_c = zones.grouped_weight_sums(
        zones.cell_keys(wz, zlev, zd, maxd), wz)
    out["GLDZM_ZDE"] = -torch.where(
        v_c, wc * torch.log2(sum_c.to(dtype) / s[:, None] + EPS),
        0).sum(dim=1) / s

    bad = (vmin == vmax) | (ns == 0)
    return {k: torch.where(bad, noval, v) for k, v in out.items()}
