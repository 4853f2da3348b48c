"""GLCM (grey-level co-occurrence matrix) features (PyTorch port of
nyxus_tpu/ops/glcm.py).

Implements the reference's GLCMFeature semantics
(reference: src/nyx/features/glcm.cpp:227-1213):

* pairs where either pixel's ORIGINAL intensity is 0 are skipped
  (glcm.cpp:443-449): background exclusion
* angles {0,45,90,135} with displacement (dx,dy) per glcm.cpp:235-255;
  the matrix is asymmetric in MATLAB-binning mode, symmetrized otherwise
* marginal conventions kept faithfully: ``by_row_mean`` is the
  neighbor-axis marginal mean and drives CLUPROM/CLUSHADE/CLUTEND for both
  mu_x and mu_y (glcm.cpp:516-538, 986-1040); JVAR deviates by matrix INDEX
  while JAVE is level-valued (glcm.cpp:1146-1195)
* entropies use the reference's float32 quadratic log (common.fast_log2)

The co-occurrence counts are K2 (``cooc_matrices``, csrc/glcm_cooc.cu).
Degenerate cases (glcm.cpp:26-100, 259-296): bin(min)==bin(max) or an empty
co-occurrence matrix emit the soft-NAN placeholder for every member.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quant
from .. import _build
from .common import (SMEM_MAX, _kernel_device, _check_float, fast_log2,
                     masked_bincount, pair_hist_plain, shifted2d)

EPS = 1e-9  # reference: glcm.h:262

# angle -> (dx, dy), reference: glcm.cpp:235-255
ANGLE_OFFSETS = {0: (1, 0), 45: (1, 1), 90: (0, 1), 135: (-1, 1)}

MEMBERS = [
    "GLCM_ACOR", "GLCM_ASM", "GLCM_CLUPROM", "GLCM_CLUSHADE", "GLCM_CLUTEND",
    "GLCM_CONTRAST", "GLCM_CORRELATION", "GLCM_DIFAVE", "GLCM_DIFENTRO",
    "GLCM_DIFVAR", "GLCM_DIS", "GLCM_ENERGY", "GLCM_ENTROPY", "GLCM_HOM1",
    "GLCM_HOM2", "GLCM_ID", "GLCM_IDN", "GLCM_IDM", "GLCM_IDMN",
    "GLCM_INFOMEAS1", "GLCM_INFOMEAS2", "GLCM_IV", "GLCM_JAVE", "GLCM_JE",
    "GLCM_JMAX", "GLCM_JVAR", "GLCM_SUMAVERAGE", "GLCM_SUMENTROPY",
    "GLCM_SUMVARIANCE", "GLCM_VARIANCE",
]
# members that have no _AVE counterpart in the featureset: HOM2
AVE_MEMBERS = [m for m in MEMBERS if m != "GLCM_HOM2"]


def cooc_matrices_plain(orig, levels, angles, offset: int, ng: int,
                        symmetric: bool):
    """Plain version of K2 (the JAX algorithm: shifted copies + a joint
    histogram per angle)."""
    B = orig.shape[0]
    lev_idx = levels.to(torch.int32) - 1
    center_valid = orig > 0
    mats = []
    for ang in angles:
        dx, dy = ANGLE_OFFSETS[ang]
        dx, dy = dx * offset, dy * offset
        nb_orig = shifted2d(orig, dx, dy)
        nb_lev = shifted2d(lev_idx, dx, dy)
        valid = (center_valid & (nb_orig > 0)).reshape(B, -1).to(orig.dtype)
        mats.append(pair_hist_plain(nb_lev.reshape(B, -1),
                                    lev_idx.reshape(B, -1), valid, ng, ng))
    M = torch.stack(mats, dim=1)
    if symmetric:
        M = M + M.transpose(-1, -2)
    return M


def cooc_matrices(orig, levels, angles, offset: int, ng: int,
                  symmetric: bool):
    """Co-occurrence count matrices for all angles: K2 glcm_cooc, replacing
    nyxus_tpu/ops/glcm.py:61 cooc_matrices.

    orig:   [B, H, W] masked original intensities (0 = background/off-ROI)
    levels: [B, H, W] int binned levels (1-based)
    -> [B, n_angles, ng, ng] counts in orig.dtype; axis 2 indexes the
    NEIGHBOR level - 1, axis 3 the CENTER level - 1.  On the card one block
    per (ROI, angle) keeps the matrix as integer counts in shared memory
    (16 KB at 64 levels): ng above 238 raises NotImplementedError.  Bound on
    the card: the crop reads and shared-memory atomics on that matrix."""
    if not _kernel_device(orig, "glcm_cooc"):
        return cooc_matrices_plain(orig, levels, angles, offset, ng,
                                   symmetric)
    _check_float(orig, "glcm_cooc")
    if orig.dim() != 3 or levels.shape != orig.shape \
            or levels.device != orig.device:
        raise ValueError("glcm_cooc: orig %s and levels %s must be [B, H, W] "
                         "on one device" % (tuple(orig.shape),
                                            tuple(levels.shape)))
    if not 1 <= len(angles) <= 4:
        raise ValueError("glcm_cooc: 1 to 4 angles expected, got %r"
                         % (angles,))
    if 4 * ng * ng > SMEM_MAX:
        raise NotImplementedError(
            "glcm_cooc: %d grey levels exceed one block's shared memory" % ng)
    orig = orig.contiguous()
    levels = levels.to(torch.int32).contiguous()
    B, H, W = orig.shape
    na = len(angles)
    out = torch.empty((B, na, ng, ng), dtype=orig.dtype, device=orig.device)
    if B == 0:
        return out
    d = []
    for k in range(4):
        dx, dy = ANGLE_OFFSETS[angles[k]] if k < na else (0, 0)
        d += [dx * offset, dy * offset]
    with torch.cuda.device(orig.device):
        code = _build.lib().nyx_glcm_cooc(
            orig.data_ptr(), levels.data_ptr(), out.data_ptr(), B, H, W, ng,
            na, *d, int(symmetric), int(orig.dtype == torch.float64),
            _build.stream_of(orig))
    _build.check("glcm_cooc", code)
    cooc_matrices.launches += 1
    return out


cooc_matrices.launches = 0


def _onehots(ng: int, dt, device):
    """Constant [ng*ng, ng] |i-j| and [ng*ng, 2ng-1] i+j one-hot maps."""
    ii = np.arange(ng)
    diff_oh = (np.abs(ii[:, None] - ii[None, :]).reshape(-1)[:, None]
               == np.arange(ng)[None, :])
    sum_oh = ((ii[:, None] + ii[None, :]).reshape(-1)[:, None]
              == np.arange(2 * ng - 1)[None, :])
    return (torch.as_tensor(diff_oh, dtype=dt, device=device),
            torch.as_tensor(sum_oh, dtype=dt, device=device))


def glcm_features_from_matrix(M, ng: int, noval: float, ng_val=None,
                              val=None, kvs=None, kvd=None):
    """All 30 angled GLCM features from count matrices.

    M: [B, A, ng, ng] counts (axis -2 = neighbor 'x', axis -1 = center 'y').
    Level values default to I[i] = i + 1.  Radiomics binning indexes the
    matrix by the RANK of each present level and passes the per-ROI arrays
    the reference derives from its unique-level vector I
    (glcm.cpp:389-398, 503-513): val [B, ng], kvs [B, 2ng-1], kvd [B, ng],
    ng_val [B].  Returns dict member -> [B, A]."""
    dt = M.dtype
    dev = M.device
    sum_p = M.sum(dim=(-1, -2))                             # [B, A]
    empty = sum_p == 0
    p = M / torch.where(empty, 1, sum_p)[..., None, None]   # joint probability

    idx = torch.arange(ng, dtype=dt, device=dev)            # 0-based index
    if val is None:
        valB = (idx + 1.0)[None, None, :]                   # level value I
    else:
        valB = val.to(dt)[:, None, :]
    valr = valB[..., :, None]
    valc = valB[..., None, :]

    px_n = p.sum(dim=-1)   # [B, A, ng] neighbor-axis marginal
    px_c = p.sum(dim=-2)   # [B, A, ng] center-axis marginal

    mr = (px_c * valB).sum(dim=-1)       # center-marginal mean
    mc = (px_n * valB).sum(dim=-1)       # neighbor-marginal mean (by_row_mean)

    diff_oh, sum_oh = _onehots(ng, dt, dev)
    pflat = p.reshape(p.shape[:-2] + (ng * ng,))
    pxmy = pflat @ diff_oh                                  # [B, A, ng]
    pxpy = pflat @ sum_oh                                   # [B, A, 2ng-1]

    k = idx                                                 # diff index values
    if kvs is None:
        s2 = (torch.arange(2 * ng - 1, dtype=dt, device=dev) + 2.0)[None, None, :]
    else:
        s2 = kvs.to(dt)[:, None, :]
    if kvd is None:
        kvdB = k[None, None, :]
    else:
        kvdB = kvd.to(dt)[:, None, :]

    out = {}
    out["GLCM_ASM"] = (p * p).sum(dim=(-1, -2))
    out["GLCM_ENERGY"] = out["GLCM_ASM"]

    dval = valr - valc
    out["GLCM_CONTRAST"] = (p * dval * dval).sum(dim=(-1, -2))

    # correlation (glcm.cpp:593-644)
    s2r = (px_c * (valB - mr[..., None]) ** 2).sum(dim=-1)
    s2c = (px_n * (valB - mc[..., None]) ** 2).sum(dim=-1)
    vb = valB.expand(p.shape[:2] + (ng,))
    cov = torch.einsum("baij,bai,baj->ba", p, vb - mc[..., None],
                       vb - mr[..., None])
    denom = torch.sqrt(s2r) * torch.sqrt(s2c)
    out["GLCM_CORRELATION"] = torch.where(
        denom > 0, cov / torch.where(denom > 0, denom, 1), noval)

    out["GLCM_VARIANCE"] = (px_c * (valB - mr[..., None]) ** 2).sum(dim=-1)

    out["GLCM_IDM"] = (pxmy / (1 + k * k)).sum(dim=-1)
    out["GLCM_SUMAVERAGE"] = (pxpy * s2).sum(dim=-1)
    out["GLCM_SUMENTROPY"] = -(pxpy * fast_log2(pxpy + EPS)).sum(dim=-1)
    out["GLCM_ENTROPY"] = -(p * fast_log2(p + EPS)).sum(dim=(-1, -2))

    # DIFAVE weights by kValuesDiff (LEVEL differences, glcm.cpp:771-780);
    # DIFVAR then deviates the INDEX k from that value (f_dvar)
    difavg = (pxmy * kvdB).sum(dim=-1)
    out["GLCM_DIFAVE"] = difavg
    out["GLCM_DIFVAR"] = ((k - difavg[..., None]) ** 2 * pxmy).sum(dim=-1)
    out["GLCM_DIFENTRO"] = -(pxmy * fast_log2(pxmy + EPS)).sum(dim=-1)

    # information measures (glcm.cpp:795-915); all "entropies" carry the
    # reference's sign convention (not negated)
    hxy = (p * fast_log2(p + EPS)).sum(dim=(-1, -2))
    pxpyij = px_n[..., :, None] * px_c[..., None, :]
    hxy1 = (p * fast_log2(pxpyij + EPS)).sum(dim=(-1, -2))
    hxy2 = (pxpyij * fast_log2(pxpyij + EPS)).sum(dim=(-1, -2))
    hx = (px_n * fast_log2(px_n + EPS)).sum(dim=-1)
    im1 = (hxy - hxy1) / hx
    out["GLCM_INFOMEAS1"] = torch.where(torch.isfinite(im1), im1, noval)
    out["GLCM_INFOMEAS2"] = torch.sqrt(torch.abs(1.0 - torch.exp(-2.0 * (hxy - hxy2))))

    out["GLCM_ACOR"] = torch.einsum("baij,bai,baj->ba", p, vb, vb)

    m_clu = valr + valc - 2.0 * mc[..., None, None]
    out["GLCM_CLUTEND"] = (m_clu ** 2 * p).sum(dim=(-1, -2))
    out["GLCM_CLUSHADE"] = (m_clu ** 3 * p).sum(dim=(-1, -2))
    out["GLCM_CLUPROM"] = (m_clu ** 4 * p).sum(dim=(-1, -2))
    out["GLCM_SUMVARIANCE"] = out["GLCM_CLUTEND"]

    absdiff = torch.abs(idx[:, None] - idx[None, :])
    out["GLCM_DIS"] = (absdiff * p).sum(dim=(-1, -2))
    out["GLCM_HOM1"] = (p / (1.0 + absdiff)).sum(dim=(-1, -2))
    out["GLCM_HOM2"] = (p / (1.0 + absdiff * absdiff)).sum(dim=(-1, -2))

    # Ng used for the IDN/IDMN normalizations
    if ng_val is None:
        ng_f = torch.tensor(float(ng), dtype=dt, device=dev)
    else:
        ng_f = ng_val.to(dt).reshape(tuple(ng_val.shape) + (1,) * (M.dim() - 2))
    out["GLCM_IDMN"] = (pxmy / (1.0 + (k * k) / (ng_f * ng_f))).sum(dim=-1)
    out["GLCM_ID"] = (pxmy / (1.0 + k)).sum(dim=-1)
    out["GLCM_IDN"] = (pxmy / (1.0 + k / ng_f)).sum(dim=-1)
    # IV weights by kValuesDiff (glcm.cpp:1116-1131)
    kk = torch.where(kvdB > 0, kvdB * kvdB, 1)
    out["GLCM_IV"] = torch.where(k > 0, pxmy / kk, 0).sum(dim=-1)

    out["GLCM_JAVE"] = mr
    out["GLCM_JE"] = out["GLCM_ENTROPY"]
    out["GLCM_JMAX"] = p.amax(dim=(-1, -2))
    # JVAR deviates the matrix INDEX x+1 from the LEVEL-VALUED joint
    # average (f_GLCM_JVAR, glcm.cpp:1185-1202)
    out["GLCM_JVAR"] = (px_n * ((idx + 1.0)[None, None, :]
                                - mr[..., None]) ** 2).sum(dim=-1)

    # per-angle empty matrix -> soft NAN (glcm.cpp:259-296)
    for m in MEMBERS:
        out[m] = torch.where(empty, noval, out[m])
    return out


def radiomics_rank_info(levels, participate, ng: int, dtype):
    """Per-ROI rank compaction for radiomics binning (glcm.cpp:389-398):
    the reference's unique-level vector I indexes the matrix by RANK.

    levels: [B, ...] radiomics-binned (0 = excluded); participate: same-shape
    bool (original intensity > 0).  Returns (rank [B, ng] (level-1 -> rank),
    val [B, ng] (I, 0-padded), kvs [B, 2ng-1], kvd [B, ng], ngp [B])."""
    B = levels.shape[0]
    dev = levels.device
    lev0 = (levels.to(torch.int32) - 1).reshape(B, -1)
    w = participate.reshape(B, -1).to(dtype)
    present = masked_bincount(lev0, w, ng) > 0                  # [B, ng]
    rank = torch.cumsum(present.to(torch.int32), dim=1) - 1     # [B, ng]
    ngp = present.to(dtype).sum(dim=1)
    # val[b, r] = level value whose rank is r
    levvals = torch.arange(1, ng + 1, dtype=dtype, device=dev).expand(B, ng)
    val = torch.zeros((B, ng), dtype=dtype, device=dev)
    val.scatter_add_(1, torch.where(present, rank, 0).long(),
                     torch.where(present, levvals, 0))

    def take(v, ix):
        """v[b, ix[b, k]] (indices are in range by construction)."""
        return v.gather(1, ix.long())

    ngp_i = ngp.to(torch.int32)
    top_i = torch.clamp(ngp_i - 1, min=0)
    ks = torch.arange(2 * ng - 1, dtype=torch.int32, device=dev)
    # kValuesSum[k]: last writer of the (x outer, y inner) loop is
    # x* = min(k, Ng-1), y* = k - x* (glcm.cpp:503-513)
    xs = torch.minimum(ks[None, :], top_i[:, None])
    ys = torch.clamp(ks[None, :] - xs, 0, ng - 1)
    kvs = take(val, xs) + take(val, ys)
    # kValuesDiff[d]: last writer x = Ng-1, y = Ng-1-d
    kd = torch.arange(ng, dtype=torch.int32, device=dev)
    top = take(val, top_i[:, None])                             # [B, 1]
    low = take(val, torch.clamp(top_i[:, None] - kd[None, :], 0, ng - 1))
    kvd = torch.abs(top - low)
    return rank, val, kvs, kvd, ngp


def _rank_per_pixel(levels, rank, ng: int):
    """rank of each pixel's level (garbage where level == 0; callers mask)."""
    B = levels.shape[0]
    lev0 = torch.clamp(levels.to(torch.int32) - 1, 0, ng - 1)
    return rank.gather(1, lev0.reshape(B, -1).long()).reshape(levels.shape)


def glcm_all(orig, levels, vmin, vmax, angles, offset: int, ng: int,
             symmetric: bool, greyinfo: int, noval: float, ng_val=None):
    """Full GLCM family: angled features + _AVE averages + degenerate gating.

    orig: [B, H, W] masked intensities; levels: binned; vmin/vmax: [B].
    Returns dict member -> [B, n_angles] and member_AVE -> [B].
    """
    if greyinfo < 0:
        # radiomics binning: rank-compacted SYMMETRIC matrix over the
        # per-ROI present-level set (glcm.cpp:389-398, 474-477)
        rank, val, kvs, kvd, ngp = radiomics_rank_info(levels, orig > 0, ng,
                                                       orig.dtype)
        rank_pix = _rank_per_pixel(levels, rank, ng)
        M = cooc_matrices(orig, rank_pix + 1, angles, offset, ng,
                          symmetric=True)
        return glcm_finalize(M, vmin, vmax, greyinfo, noval, ng_val=ngp,
                             val=val, kvs=kvs, kvd=kvd)
    M = cooc_matrices(orig, levels, angles, offset, ng, symmetric)
    return glcm_finalize(M, vmin, vmax, greyinfo, noval, ng_val)


def glcm_finalize(M, vmin, vmax, greyinfo: int, noval: float, ng_val=None,
                  val=None, kvs=None, kvd=None):
    """Features + _AVE means + degenerate gating from count matrices
    M: [B, A, ng, ng]."""
    ng = M.shape[-1]
    out = glcm_features_from_matrix(M, ng, noval, ng_val, val=val, kvs=kvs,
                                    kvd=kvd)
    degen = quant.binned_range_degenerate(vmin, vmax, greyinfo)   # [B]
    final = {}
    for m in MEMBERS:
        final[m] = torch.where(degen[:, None], noval, out[m])
    for m in AVE_MEMBERS:
        ave = final[m].mean(dim=-1)
        final[m + "_AVE"] = torch.where(degen, noval, ave)
    return final
