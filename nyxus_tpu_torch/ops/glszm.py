"""GLSZM (grey-level size-zone matrix) features (PyTorch port of
nyxus_tpu/ops/glszm.py).

Reference: src/nyx/features/glszm.cpp:60-770.  Zones found by the reference's
directed zone scan (K5, ops/zones.zone_labels) and listed per zone (K7,
ops/zones.zone_list); 16 statistics over the implicit (level, zone size)
matrix, computed from per-zone quantities without materializing the
[Ng, H*W] matrix:

* per-zone sums for SAE/LAE/GLV/ZV/LGLZE/HGLZE/SALGLE/SAHGLE/LALGLE/LAHGLE
* grouped sums for the marginal-squared features GLN(N)/SZN(N) and the
  (level, size)-grouped entropy ZE, which uses the reference's float32
  fast_log2

Faithful notes:
* MATLAB binning: AABB background (level 1) forms zones; Np = AABB area
  (glszm.cpp:166-179 counts VISITED-marked pixels)
* blank ROI (min == max) or empty matrix -> all members soft-NAN
* the ZE cell key (level, size) is built in int64 (zones.cell_keys): the
  JAX package's key in the compute dtype merges distinct cells in float32
  once level * (A + 1) passes 2^24 (a 512 x 512 bucket at 64 levels).  f64
  results are the same either way.
"""

from __future__ import annotations

import torch

from . import zones
from .common import counted, fast_log2

EPS = 2.2e-16  # reference: glrlm.h:169 / glszm.h:138 / gldm.h:105

MEMBERS = [
    "GLSZM_SAE", "GLSZM_LAE", "GLSZM_GLN", "GLSZM_GLNN", "GLSZM_SZN",
    "GLSZM_SZNN", "GLSZM_ZP", "GLSZM_GLV", "GLSZM_ZV", "GLSZM_ZE",
    "GLSZM_LGLZE", "GLSZM_HGLZE", "GLSZM_SALGLE", "GLSZM_SAHGLE",
    "GLSZM_LALGLE", "GLSZM_LAHGLE",
]


def _inv(x):
    return 1.0 / torch.where(x > 0, x, 1)


def _grouped_square_sum(keys, w, dtype):
    """Sum over groups of (group weight sum)^2, each row adding w * its
    group's sum (exact for one row per zone and for aggregated rows)."""
    _, wg, sums, v = zones.grouped_weight_sums(keys, w)
    return torch.where(v, wg * sums, 0).to(dtype).sum(dim=1)


def glszm_features(levels, valid, np_pixels, vmin, vmax, noval: float, dtype):
    """levels: [B, H, W] int32 binned (1-based; 0 = non-participating);
    valid: participation mask; np_pixels: [B] the Np normalizer.
    Returns dict member -> [B]."""
    B, H, W = levels.shape
    anc = zones.zone_labels(levels, valid)
    zlev_i, zsize_i, _, ok = zones.zone_list(anc, levels, valid)
    return glszm_features_from_zones(zlev_i.to(dtype), zsize_i.to(dtype),
                                     ok.to(dtype), np_pixels, vmin, vmax,
                                     noval, dtype, H * W + 1)


@counted
def glszm_features_from_zones(zlev, zsize, w, np_pixels, vmin, vmax,
                              noval: float, dtype, size_key: int):
    """The 16 statistics from per-zone (level, size) lists.

    zlev/zsize: [B, Z] zone grey level and pixel count (0 where w == 0);
    w: [B, Z] 1.0 at real zones (the zone multiplicity); size_key: any
    integer > max zone size (ZE cell key stride)."""
    nz = w.sum(dim=1)                              # sum_p = number of zones
    s = torch.clamp(nz, min=1)
    l2 = zlev * zlev
    s2 = zsize * zsize

    out = {}
    out["GLSZM_SAE"] = (w * _inv(s2)).sum(dim=1) / s
    out["GLSZM_LAE"] = (w * s2).sum(dim=1) / s
    out["GLSZM_ZP"] = nz / torch.clamp(np_pixels.to(dtype), min=1)
    mu_g = (w * zlev).sum(dim=1) / s
    out["GLSZM_GLV"] = (w * (zlev - mu_g[:, None]) ** 2).sum(dim=1) / s
    mu_z = (w * zsize).sum(dim=1) / s
    out["GLSZM_ZV"] = (w * (zsize - mu_z[:, None]) ** 2).sum(dim=1) / s
    out["GLSZM_LGLZE"] = (w * _inv(l2)).sum(dim=1) / s
    out["GLSZM_HGLZE"] = (w * l2).sum(dim=1) / s
    out["GLSZM_SALGLE"] = (w * _inv(l2) * _inv(s2)).sum(dim=1) / s
    out["GLSZM_SAHGLE"] = (w * l2 * _inv(s2)).sum(dim=1) / s
    out["GLSZM_LALGLE"] = (w * s2 * _inv(l2)).sum(dim=1) / s
    out["GLSZM_LAHGLE"] = (w * l2 * s2).sum(dim=1) / s

    inf = torch.tensor(float("inf"), dtype=dtype, device=w.device)
    gln = _grouped_square_sum(torch.where(w > 0, zlev, inf), w, dtype)
    out["GLSZM_GLN"] = gln / s
    out["GLSZM_GLNN"] = gln / (s * s)
    szn = _grouped_square_sum(torch.where(w > 0, zsize, inf), w, dtype)
    out["GLSZM_SZN"] = szn / s
    out["GLSZM_SZNN"] = szn / (s * s)

    # ZE: cells grouped by (level, size); per zone: w * log2(c/Nz + EPS)/Nz
    _, wc, sum_c, v_c = zones.grouped_weight_sums(
        zones.cell_keys(w, zlev, zsize, size_key), w)
    out["GLSZM_ZE"] = -torch.where(
        v_c, wc * fast_log2(sum_c.to(dtype) / s[:, None] + EPS),
        0).sum(dim=1) / s

    bad = (vmin == vmax) | (nz == 0)
    return {k: torch.where(bad, noval, v) for k, v in out.items()}
