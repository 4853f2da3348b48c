# Ported from nyxus_tpu/pipeline/oversized3d.py; pinned by tests/test_torch_tables.py.
"""Slice-streamed oversized-ROI path for 3D volumes (PyTorch port of
nyxus_tpu/pipeline/oversized3d.py; reference phase 3 for 3D: every family's
``osized_calculate``, phase3.cpp:94-114).

A 3D ROI whose padded cube exceeds the batch budget never materializes as a
dense [D, H, W] device tensor.  Instead one z-slice-streamed pass over the
ROI's AABB (``accumulate3d``) builds the same sufficient statistics the
dense kernels consume -- GLCM direction matrices, GLRLM run histograms
(with cross-slice run carries), GLSZM/GLDZM zone lists (union-find over
per-slice runs), GLDM/NGLDM dependence matrices, NGTDM neighbor sums, the
exact intensity histogram, and the surface sums.  Only one
(2*r+1)-slice window plus O(runs) union-find state is resident at any
time; the volume itself is accessed through numpy views (or a lazy
layout-A stack, plane by plane).

The accumulators are numpy, as in the JAX package, and verbatim copies of
its code (``_shift2`` to ``is_oversized3d``, the body of
``accumulate3d``, ``_surface_members``).  Their finish stages
(``FINISH3D``, one a family) run in float64 on the runner's torch device,
whatever the request's precision, through the SAME feature functions as
the trivial path (``ops/texture3d.py``, ``ops/glrlm.py``, ``ops/glszm.py``,
``ops/gldzm.py``, ``ops/gldm.py``, ``ops/ngtdm.py``): the intensity
statistics' histograms through K1 (``masked_bincount``) on a CUDA device,
their plain versions on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.texture3d import GLCM_SHIFTS, GLRLM_SHIFTS
from . import batching
from . import oversized as ovs
from .oversized_tex import bin_levels_np, _UnionFind

def _shift2(a, dy, dx, fill=0):
    """a[y + dy, x + dx] with constant fill outside (numpy, 2D)."""
    H, W = a.shape
    out = np.full_like(a, fill)
    ys = slice(max(dy, 0), H + min(dy, 0))
    yd = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    xd = slice(max(-dx, 0), W + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


def _pair_hist_np(a, b, w, ni, nj, out):
    """out[a, b] += w for in-range index pairs (accumulating)."""
    ok = (a >= 0) & (a < ni) & (b >= 0) & (b < nj) & (w != 0)
    if not ok.any():
        return
    comp = a[ok].astype(np.int64) * nj + b[ok]
    out.ravel()[:] += np.bincount(comp, weights=w[ok],
                                  minlength=ni * nj)


# ---------------------------------------------------------------------------
# GLRLM runs with cross-slice carries


class Runs3DAccum:
    """Run-length histograms along the 13 directions; dz=0 directions are
    slice-local, dz=1 directions carry (level, length) state between
    consecutive slices."""

    def __init__(self, ng, nr, H, W):
        self.ng, self.nr = ng, nr
        self.P = np.zeros((13, ng, nr))
        # dz=1 carries: level (-1 = none) and length of the run ENDING at
        # each (y, x) of the previous slice
        self.carry = {}
        for di, (dz, dy, dx) in enumerate(GLRLM_SHIFTS):
            if dz == 1:
                self.carry[di] = (np.full((H, W), -1, np.int64),
                                  np.zeros((H, W), np.int64))

    def _flush(self, di, lev, length, mask):
        if not mask.any():
            return
        _pair_hist_np(lev[mask] - 1,
                      np.minimum(length[mask] - 1, self.nr - 1),
                      np.ones(int(mask.sum())), self.ng, self.nr, self.P[di])

    def _runs_inplane(self, di, dy, dx, lv, ok):
        """Maximal runs of one slice along (dy, dx): flatten along the
        direction via shear so runs become contiguous x-segments."""
        H, W = lv.shape
        if (dy, dx) == (0, 1):
            l2, o2 = lv, ok
        else:
            # shear rows so the (dy, dx) diagonal/column becomes horizontal:
            # row y shifted right by y (dx == -1), left-aligned (dx == 1),
            # or transpose (vertical)
            if (dy, dx) == (1, 0):
                l2, o2 = lv.T, ok.T
            else:
                K = W + H
                l2 = np.zeros((H, K), lv.dtype)
                o2 = np.zeros((H, K), bool)
                for y in range(H):
                    s = y if dx == -1 else H - 1 - y
                    l2[y, s:s + W] = lv[y]
                    o2[y, s:s + W] = ok[y]
                l2, o2 = l2.T, o2.T     # runs go down columns -> transpose
        # contiguous horizontal runs of same level among ok cells
        flat_l = l2.reshape(-1)
        flat_o = o2.reshape(-1)
        Wr = l2.shape[1]
        idx = np.arange(flat_l.size)
        rowstart = (idx % Wr) == 0
        same_prev = np.zeros(flat_l.size, bool)
        same_prev[1:] = (flat_o[1:] & flat_o[:-1]
                         & (flat_l[1:] == flat_l[:-1]))
        same_prev[rowstart] = False
        starts = flat_o & ~same_prev
        sidx = np.nonzero(starts)[0]
        if not len(sidx):
            return
        # run length: distance to the next break
        breaks = np.nonzero(~np.concatenate([same_prev[1:], [False]]))[0]
        ends = breaks[np.searchsorted(breaks, sidx)]
        lengths = ends - sidx + 1
        _pair_hist_np(flat_l[sidx] - 1,
                      np.minimum(lengths - 1, self.nr - 1),
                      np.ones(len(sidx)), self.ng, self.nr, self.P[di])

    def feed_slice(self, lv, ok):
        """lv: [H, W] levels; ok: validity."""
        for di, (dz, dy, dx) in enumerate(GLRLM_SHIFTS):
            if dz == 0:
                self._runs_inplane(di, dy, dx, lv, ok)
                continue
            plev, plen = self.carry[di]
            # chain: (z-1, y-dy, x-dx) -> (z, y, x)
            prev_lev = _shift2(plev, -dy, -dx, fill=-1)
            prev_len = _shift2(plen, -dy, -dx, fill=0)
            cont = ok & (prev_lev >= 0) & (lv == prev_lev)
            # previous runs whose chain does NOT continue are maximal: flush
            cont_back = _shift2(cont.astype(np.int64), dy, dx) > 0
            ended = (plev >= 0) & ~cont_back
            self._flush(di, plev, plen, ended)
            nlev = np.where(ok, lv, -1)
            nlen = np.where(ok, np.where(cont, prev_len + 1, 1), 0)
            self.carry[di] = (nlev.astype(np.int64), nlen.astype(np.int64))

    def finish(self):
        for di, (dz, dy, dx) in enumerate(GLRLM_SHIFTS):
            if dz == 1:
                plev, plen = self.carry[di]
                self._flush(di, plev, plen, plev >= 0)
        return self.P


# ---------------------------------------------------------------------------
# zone tracking (26-conn for GLSZM, 6-conn for GLDZM) via per-slice runs +
# union-find across rows and slices


class Zones3DAccum:
    def __init__(self, conn26: bool, want_dist: bool):
        self.conn26 = conn26
        self.want_dist = want_dist
        self.uf = _UnionFind()
        self.z_lev = []          # per UF node: level
        self.z_size = []
        self.z_dist = []
        self.prev_rows = None    # per-row run lists of the previous slice

    def _slice_runs(self, lv, ok, dist=None):
        """Label one slice's same-level runs and union them in-plane.

        Returns rows: list per y of (xstart, xend, level, node)."""
        H, W = lv.shape
        rows = []
        prev_row = []
        offs = ((-1, 0, 1) if self.conn26 else (0,))
        for y in range(H):
            o = ok[y]
            runs = []
            if o.any():
                l = lv[y]
                idx = np.nonzero(o)[0]
                brk = np.nonzero(np.diff(idx) > 1)[0]
                seg_starts = np.concatenate([[0], brk + 1])
                seg_ends = np.concatenate([brk, [len(idx) - 1]])
                for a, b in zip(seg_starts, seg_ends):
                    x0, x1 = int(idx[a]), int(idx[b])
                    # split by level changes within the contiguous segment
                    s = x0
                    for x in range(x0 + 1, x1 + 2):
                        if x > x1 or l[x] != l[s]:
                            node = self.uf.make()
                            self.z_lev.append(int(l[s]))
                            self.z_size.append(0)
                            self.z_dist.append(1 << 30)
                            cnt = x - s
                            self._bump(node, cnt,
                                       None if dist is None
                                       else int(dist[y, s:x].min()))
                            runs.append((s, x - 1, int(l[s]), node))
                            s = x
            # vertical unions with the previous row
            for (s, e, levv, node) in runs:
                for (ps, pe, plev, pnode) in prev_row:
                    if plev != levv:
                        continue
                    if (ps <= e + max(offs)) and (pe >= s + min(offs)):
                        self._union(node, pnode)
            rows.append(runs)
            prev_row = runs
        return rows

    def _bump(self, node, cnt, dist):
        r = self.uf.find(node)
        self.z_size[r] += cnt
        if dist is not None and dist < self.z_dist[r]:
            self.z_dist[r] = dist

    def _union(self, a, b):
        ra, rb = self.uf.find(a), self.uf.find(b)
        if ra == rb:
            return
        r = self.uf.union(ra, rb)
        o = rb if r == ra else ra
        self.z_size[r] += self.z_size[o]
        if self.z_dist[o] < self.z_dist[r]:
            self.z_dist[r] = self.z_dist[o]

    def feed_slice(self, lv, ok, dist=None):
        rows = self._slice_runs(lv, ok, dist)
        if self.prev_rows is not None:
            offs = ((-1, 0, 1) if self.conn26 else (0,))
            for dy in offs:
                for y, runs in enumerate(rows):
                    py = y + dy
                    if py < 0 or py >= len(self.prev_rows):
                        continue
                    prev = self.prev_rows[py]
                    for (s, e, levv, node) in runs:
                        for (ps, pe, plev, pnode) in prev:
                            if plev != levv:
                                continue
                            lo = min(offs)
                            hi = max(offs)
                            if (ps <= e + hi) and (pe >= s + lo):
                                self._union(node, pnode)
        self.prev_rows = rows

    def zone_lists(self):
        """(zlev, zsize, zdist) arrays, one entry per final zone."""
        roots = [i for i in range(len(self.z_size))
                 if self.uf.find(i) == i and self.z_size[i] > 0]
        zl = np.asarray([self.z_lev[r] for r in roots], np.float64)
        zs = np.asarray([self.z_size[r] for r in roots], np.float64)
        zd = np.asarray([self.z_dist[r] for r in roots], np.float64)
        return zl, zs, zd


def _border_distance_np(lev, h, w):
    """Per-pixel in-plane dist2border, mirroring ops/gldzm.border_distance
    (nearest zero-level strictly along each scanline, or the AABB margin)."""
    H, W = lev.shape
    xs = np.arange(W)[None, :]
    ys = np.arange(H)[:, None]
    zero = lev == 0
    NEG, POS = -(1 << 30), (1 << 30)
    zl = np.maximum.accumulate(np.where(zero, xs, NEG), axis=1)
    zl = _shift2(zl, 0, -1, fill=NEG)             # strictly left
    zr = np.minimum.accumulate(np.where(zero, xs, POS)[:, ::-1],
                               axis=1)[:, ::-1]
    zr = _shift2(zr, 0, 1, fill=POS)              # strictly right
    zt = np.maximum.accumulate(np.where(zero, ys, NEG), axis=0)
    zt = _shift2(zt, -1, 0, fill=NEG)
    zb = np.minimum.accumulate(np.where(zero, ys, POS)[::-1], axis=0)[::-1]
    zb = _shift2(zb, 1, 0, fill=POS)
    d = np.minimum(np.minimum(np.minimum(xs - zl, xs),
                              np.minimum(zr - xs, (w - 1) - xs)),
                   np.minimum(np.minimum(ys - zt, ys),
                              np.minimum(zb - ys, (h - 1) - ys))) + 1
    return np.maximum(d, 1)



def is_oversized3d(rec, budget_bytes, bytes_per_px=16):
    dims = (rec.depth, rec.height, rec.width)
    if max(dims) > batching._LADDER[-1]:
        return True
    pd = batching.pad_dim(rec.depth)
    ph = batching.pad_dim(rec.height)
    pw = batching.pad_dim(rec.width)
    return pd * ph * pw * bytes_per_px > budget_bytes


class Accum3D:
    """One oversized 3D ROI's streamed statistics (``accumulate3d``): the
    record, the configuration, the wanted families, the accumulators, the
    finished run matrices, the value histogram and surface sums, the
    padded cube (pd, ph, pw), the slide range, and ``grey(family)``, each
    family's (greyinfo, matrix size).  Its finish stages may run any
    number of times."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def accumulate3d(rec, intens, labels, cfg, families, smin, smax):
    """The streamed pass of ``process3d`` over one 3D ROI (the JAX
    package's code up to its finish, line for line).  intens/labels:
    whole-volume numpy arrays (views are sliced per z) or lazy stacks."""
    D_, H_, W_ = rec.depth, rec.height, rec.width
    sub_i = intens[rec.z0:rec.z1 + 1, rec.y0:rec.y1 + 1,
                   rec.x0:rec.x1 + 1]
    sub_l = labels[rec.z0:rec.z1 + 1, rec.y0:rec.y1 + 1,
                   rec.x0:rec.x1 + 1]
    pd = batching.pad_dim(D_) if D_ <= batching._LADDER[-1] else \
        1 << (D_ - 1).bit_length()
    ph = batching.pad_dim(H_) if H_ <= batching._LADDER[-1] else \
        1 << (H_ - 1).bit_length()
    pw = batching.pad_dim(W_) if W_ <= batching._LADDER[-1] else \
        1 << (W_ - 1).bit_length()

    out = {}
    ibsi = cfg.ibsi
    if ibsi:
        ceil = max(int(smax), 2)
        ng_ibsi = 1 << (ceil - 1).bit_length()

    def grey(family=None):
        if ibsi:
            return 0, ng_ibsi
        g = cfg.texture_greydepth3(family) if family else cfg.coarse_gray_depth
        if g == 0:
            # per-family zero default -> raw-intensity levels sized by the
            # slide max (texture_feature.h:71-75)
            return 0, max(int(smax), 2)
        return g, g

    want = set(families)
    lev_cache = {}

    def lev_at(z, gi):
        key = (z, gi)
        if key not in lev_cache:
            m = sub_l[z] == rec.label
            mi = np.where(m, sub_i[z], 0).astype(np.float64)
            lev_cache[key] = bin_levels_np(mi, rec.vmin, rec.vmax, gi)
            # drop stale slices (keep a window of 5)
            for k in list(lev_cache):
                if k[0] < z - 4:
                    del lev_cache[k]
        return lev_cache[key]

    def mask_at(z):
        return sub_l[z] == rec.label

    # --- accumulators ---------------------------------------------------
    accs = {}
    if "D3_GLCM_feature" in want:
        gi_glcm, ng_glcm = grey("glcm")
        accs["glcm"] = np.zeros((13, ng_glcm, ng_glcm))
    if "D3_GLRLM_feature" in want:
        gi_glrlm, ng_glrlm = grey("glrlm")
        nr = max(pd, ph, pw)
        accs["glrlm"] = Runs3DAccum(ng_glrlm, nr, H_, W_)
    if "D3_GLSZM_feature" in want:
        gi_glszm, ng_glszm = grey("glszm")
        accs["glszm"] = Zones3DAccum(conn26=True, want_dist=False)
    if "D3_GLDZM_feature" in want:
        gi_gldzm, ng_gldzm = grey()
        accs["gldzm"] = Zones3DAccum(conn26=False, want_dist=True)
    if "D3_GLDM_feature" in want:
        gi_gldm, ng_gldm = grey("gldm")
        accs["gldm"] = np.zeros((ng_gldm, 27))
    if "D3_NGLDM_feature" in want:
        nb_ngldm = (ng_ibsi if ibsi else cfg.coarse_gray_depth) + 1
        accs["ngldm_P"] = np.zeros((nb_ngldm, 25))
        accs["ngldm_present"] = np.zeros(nb_ngldm, bool)
    if "D3_NGTDM_feature" in want:
        gi_ngtdm, ng_ngtdm = grey("ngtdm")
        nbt = ng_ngtdm + 1
        accs["ngtdm_N"] = np.zeros(nbt)
        accs["ngtdm_S"] = np.zeros(nbt)
        accs["ngtdm_present"] = np.zeros(nbt, bool)
        accs["ngtdm_maxlev"] = 0
    if "D3_VoxelIntensityFeatures" in want:
        hist = ovs.OversizedAccums()
    if "D3_SurfaceFeature" in want:
        surf = dict(n=0, faces=0, hull_pts=[],
                    s=np.zeros(3), ss=np.zeros((3, 3)))

    r_ngtdm = cfg.d3_ngtdm_radius if "D3_NGTDM_feature" in want else 1
    if r_ngtdm <= 0:
        # radius 0 short-circuits to all-zero members at finalize; skip the
        # per-slice neighborhood accumulation entirely
        want_ngtdm_accum = False
        r_ngtdm = 1
    else:
        want_ngtdm_accum = True
    off_glcm = cfg.glcm3_offset if "D3_GLCM_feature" in want else 1
    zwin = max(r_ngtdm, off_glcm, 1)

    def ngldm_lev(z):
        m = mask_at(z)
        mi = np.where(m, sub_i[z], 0).astype(np.float64)
        if ibsi:
            return mi.astype(np.int64)
        n_levels = cfg.coarse_gray_depth
        return (mi * n_levels / max(rec.vmax, 1e-30)).astype(np.int64)

    for z in range(D_):
        m = mask_at(z)

        if "D3_VoxelIntensityFeatures" in want:
            vals = sub_i[z][m]
            if vals.size:
                hist.area += vals.size
                hist.vmin = min(hist.vmin, float(vals.min()))
                hist.vmax = max(hist.vmax, float(vals.max()))
                bu, bc = np.unique(vals, return_counts=True)
                ovs._merge_hist(hist, bu.astype(np.float64),
                                bc.astype(np.float64))

        if "D3_SurfaceFeature" in want and m.any():
            yy, xx = np.nonzero(m)
            surf["n"] += len(yy)
            pts = np.stack([xx + rec.x0, yy + rec.y0,
                            np.full(len(yy), z + rec.z0)], 1).astype(float)
            surf["s"] += pts.sum(0)
            surf["ss"] += pts.T @ pts
            # exposed faces: 4 in-plane + 2 axial
            faces = 0
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                faces += int((m & ~_shift2(m, dy, dx, fill=False)).sum())
            up = mask_at(z - 1) if z > 0 else np.zeros_like(m)
            dn = mask_at(z + 1) if z + 1 < D_ else np.zeros_like(m)
            faces += int((m & ~up).sum()) + int((m & ~dn).sum())
            surf["faces"] += faces
            # 2D hull vertices of this slice bound the 3D hull vertices
            if len(yy) >= 3:
                try:
                    from scipy.spatial import ConvexHull
                    h2 = ConvexHull(pts[:, :2])
                    surf["hull_pts"].append(pts[h2.vertices])
                except Exception:
                    surf["hull_pts"].append(pts)
            else:
                surf["hull_pts"].append(pts)

        if "D3_GLCM_feature" in want:
            lv = lev_at(z, gi_glcm)
            b_idx = lv.astype(np.int64) - 1
            for di, (dx, dy, dz) in enumerate(GLCM_SHIFTS):
                zz = z + dz * off_glcm
                if zz < 0 or zz >= D_:
                    continue
                nlv = lev_at(zz, gi_glcm)
                a_idx = _shift2(nlv.astype(np.int64) - 1,
                                dy * off_glcm, dx * off_glcm, fill=-1)
                nb_ok = _shift2(np.ones_like(m, np.int64),
                                dy * off_glcm, dx * off_glcm) > 0
                valid = nb_ok
                if gi_glcm == 0:
                    valid = valid & (lv > 0) & (a_idx >= 0)
                _pair_hist_np(a_idx, b_idx, valid.astype(np.float64),
                              accs["glcm"].shape[1], accs["glcm"].shape[1],
                              accs["glcm"][di])

        if "D3_GLRLM_feature" in want:
            lv = lev_at(z, gi_glrlm).astype(np.int64)
            ok = np.ones_like(lv, bool) if gi_glrlm > 0 else (lv > 0)
            accs["glrlm"].feed_slice(lv, ok)

        if "D3_GLSZM_feature" in want:
            lv = lev_at(z, gi_glszm).astype(np.int64)
            zero_i = 1 if gi_glszm > 0 else 0
            ok = lv != zero_i
            accs["glszm"].feed_slice(np.where(ok, lv, -1), ok)

        if "D3_GLDZM_feature" in want:
            lv = lev_at(z, gi_gldzm).astype(np.int64)
            ok = np.ones_like(lv, bool) if gi_gldzm > 0 else (lv > 0)
            dist = _border_distance_np(lv, H_, W_)
            accs["gldzm"].feed_slice(lv, ok, dist)

        if "D3_GLDM_feature" in want:
            lv = lev_at(z, gi_gldm).astype(np.int64)
            zero_i = 1 if gi_gldm > 0 else 0
            nd = np.ones_like(lv, np.int64)
            for dz in (-1, 0, 1):
                zz = z + dz
                if zz < 0 or zz >= D_:
                    continue
                nlv = lev_at(zz, gi_gldm).astype(np.int64)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if dz == 0 and dy == 0 and dx == 0:
                            continue
                        sh = _shift2(nlv, dy, dx, fill=-99)
                        inb = _shift2(np.ones_like(lv), dy, dx) > 0
                        nd += (inb & (sh == lv)).astype(np.int64)
            center_ok = lv != zero_i
            _pair_hist_np(lv - 1, nd - 1, center_ok.astype(np.float64),
                          accs["gldm"].shape[0], 27, accs["gldm"])

        if "D3_NGLDM_feature" in want:
            lv = ngldm_lev(z)
            nbv = accs["ngldm_P"].shape[0]
            matches = np.zeros_like(lv)
            for dz in (-1, 0, 1):
                zz = z + dz
                if zz < 0 or zz >= D_:
                    continue
                nlv = ngldm_lev(zz)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        # reference 3D NGLDM omits the axial (0,0,+-1)
                        # neighbors -- 24 shifts (3d_ngldm.cpp:12-40)
                        if dy == 0 and dx == 0:
                            continue
                        sh = _shift2(nlv, dy, dx, fill=-99)
                        inb = _shift2(np.ones_like(lv), dy, dx) > 0
                        matches += (inb & (sh == lv)).astype(np.int64)
            interior_z = 1 <= z < D_ - 1
            if interior_z:
                ys = np.arange(H_)[:, None]
                xs = np.arange(W_)[None, :]
                interior = ((ys >= 1) & (ys < H_ - 1) &
                            (xs >= 1) & (xs < W_ - 1))
                _pair_hist_np(np.clip(lv, 0, nbv - 1),
                              np.clip(matches, 0, 24),
                              interior.astype(np.float64), nbv, 25,
                              accs["ngldm_P"])
            accs["ngldm_present"][np.unique(np.clip(lv, 0, nbv - 1))] = True

        if "D3_NGTDM_feature" in want and want_ngtdm_accum:
            lv = lev_at(z, gi_ngtdm).astype(np.int64)
            zero_i = 1 if gi_ngtdm > 0 else 0
            lv_f = lv.astype(np.float64)
            neig_sum = np.zeros_like(lv_f)
            neig_cnt = np.zeros_like(lv_f)
            r = r_ngtdm
            for dz in range(-r, r + 1):
                zz = z + dz
                if zz < 0 or zz >= D_:
                    continue
                nlv = lev_at(zz, gi_ngtdm).astype(np.float64)
                for dy in range(-r, r + 1):
                    for dx in range(-r, r + 1):
                        if dz == 0 and dy == 0 and dx == 0:
                            continue
                        sh = _shift2(nlv, dy, dx, fill=0.0)
                        inb = _shift2(np.ones_like(lv), dy, dx) > 0
                        neig_sum += np.where(inb, sh, 0)
                        neig_cnt += inb
            is_zone = (lv != zero_i) & (neig_cnt > 0)
            ave = np.where(is_zone, neig_sum / np.maximum(neig_cnt, 1), 0)
            nbt = len(accs["ngtdm_N"])
            cl = np.clip(lv, 0, nbt - 1)
            accs["ngtdm_N"] += np.bincount(cl[is_zone], minlength=nbt)
            accs["ngtdm_S"] += np.bincount(
                cl[is_zone], weights=np.abs(lv_f - ave)[is_zone],
                minlength=nbt)
            accs["ngtdm_present"][np.unique(cl)] = True
            accs["ngtdm_maxlev"] = max(accs["ngtdm_maxlev"], int(lv.max()))

    return Accum3D(
        rec=rec, cfg=cfg, want=want, accs=accs, grey=grey, pads=(pd, ph, pw),
        smin=smin, smax=smax,
        # the run matrices with the last slice's runs flushed (once: the
        # flush adds to them)
        runs=accs["glrlm"].finish() if "glrlm" in accs else None,
        hist=hist if "D3_VoxelIntensityFeatures" in want else None,
        surf=surf if "D3_SurfaceFeature" in want else None)


# ---------------------------------------------------------------------------
# the finish stages: the SAME statistics as the dense path, in float64 on
# ``device``, one function a family (the JAX package's jit_finish calls,
# nyxus_tpu/pipeline/oversized3d.py:559-676)

NGTDM_MEMBERS = ("NGTDM_COARSENESS", "NGTDM_CONTRAST", "NGTDM_BUSYNESS",
                 "NGTDM_COMPLEXITY", "NGTDM_STRENGTH")


def _extrema(acc, device):
    return (ovs._dev([acc.rec.vmin], device), ovs._dev([acc.rec.vmax], device))


def _finish_intensity(acc, device):
    """The weighted ``pixel_intensity_features`` over the streamed value
    histogram (its histograms through K1 on a CUDA device)."""
    from ..ops.intensity import pixel_intensity_features
    hist = acc.hist
    if not hist.area:
        return None
    U = ovs._pad_pow2(hist.vals.size)
    va = np.full((1, U), np.inf)
    wt = np.zeros((1, U))
    va[0, :hist.vals.size] = hist.vals
    wt[0, :hist.vals.size] = hist.cnts
    vmin1, vmax1 = _extrema(acc, device)
    return ovs._host(pixel_intensity_features(
        ovs._dev(va, device), ovs._dev([hist.area], device, torch.int64),
        vmin1, vmax1, ovs._dev([acc.smax - acc.smin], device),
        acc.cfg.coarse_gray_depth, acc.cfg.noval,
        weights=ovs._dev(wt, device)))


def _finish_glcm(acc, device):
    """``glcm3d_finalize`` over the 13 direction matrices, symmetrised in
    IBSI mode."""
    from ..ops import texture3d as t3
    gi, _ = acc.grey("glcm")
    M = acc.accs["glcm"][None]
    if acc.cfg.ibsi:
        M = M + np.swapaxes(M, -1, -2)
    vmin1, vmax1 = _extrema(acc, device)
    return ovs._host(t3.glcm3d_finalize(
        ovs._dev(M, device), vmin1, vmax1, gi, acc.cfg.noval,
        ovs.FINISH_DTYPE, vmax1 if acc.cfg.ibsi else None))


def _finish_glrlm(acc, device):
    """``glrlm_features`` over the 13 run matrices: each member's
    direction 0 and its mean over the 13."""
    from ..ops import glrlm as glrlm2d
    P = acc.runs[None]
    vmin1, vmax1 = _extrema(acc, device)
    res = ovs._host(glrlm2d.glrlm_features(
        ovs._dev(P, device), ovs._dev([acc.rec.area], device), vmin1, vmax1,
        acc.cfg.noval, ovs.FINISH_DTYPE))
    fin = {}
    for m in glrlm2d.MEMBERS:
        fin[m] = float(res[m][0])
        fin[m + "_AVE"] = float(res[m + "_AVE"])
    return fin


def _zone_tensors(zl, zv, device):
    """Zone lists (level, size or distance) as [1, Z] tensors of their
    unique pairs and multiplicities, padded to a power of two."""
    zlev, zval, w = ovs._agg_zones(zl[None], zv[None], np.ones((1, zl.size)))
    pad = ((0, 0), (0, ovs._pow2(zlev.shape[1]) - zlev.shape[1]))
    return [ovs._dev(np.pad(a, pad), device) for a in (zlev, zval, w)]


def _finish_glszm(acc, device):
    """The 16 size-zone statistics over the 26-connected zone list."""
    from ..ops import glszm as glszm2d
    zl, zs, _ = acc.accs["glszm"].zone_lists()
    pd, ph, pw = acc.pads
    zlev, zsize, w = _zone_tensors(zl, zs, device)
    vmin1, vmax1 = _extrema(acc, device)
    return ovs._host(glszm2d.glszm_features_from_zones(
        zlev, zsize, w, ovs._dev([acc.rec.area], device), vmin1, vmax1,
        acc.cfg.noval, ovs.FINISH_DTYPE, pd * ph * pw + 1))


def _finish_gldzm(acc, device):
    """The 18 distance-zone statistics over the 6-connected zone list, its
    zones of level 0 left out."""
    from ..ops import gldzm as gldzm2d
    zl, _, zd = acc.accs["gldzm"].zone_lists()
    _, ph, pw = acc.pads
    keep = zl > 0
    zlev, zdist, wz = _zone_tensors(zl[keep], zd[keep], device)
    vmin1, vmax1 = _extrema(acc, device)
    return ovs._host(gldzm2d.gldzm_features_from_zones(
        zlev, zdist, wz, ovs._dev([acc.rec.area], device), vmin1, vmax1,
        acc.cfg.noval, ovs.FINISH_DTYPE, ph + pw + 2))


def _finish_gldm(acc, device):
    """``gldm_features`` over the 27-column dependence matrix."""
    from ..ops import gldm as gldm2d
    vmin1, vmax1 = _extrema(acc, device)
    return ovs._host(gldm2d.gldm_features(
        ovs._dev(acc.accs["gldm"][None], device), vmin1, vmax1,
        acc.cfg.noval))


def _finish_ngldm(acc, device):
    """``ngldm3d_from_matrix`` over the 25-column dependence matrix and the
    present levels."""
    from ..ops import texture3d as t3
    vmin1, vmax1 = _extrema(acc, device)
    return ovs._host(t3.ngldm3d_from_matrix(
        ovs._dev(acc.accs["ngldm_P"][None], device),
        ovs._dev(acc.accs["ngldm_present"][None], device, torch.bool),
        vmin1, vmax1, acc.cfg.noval, ovs.FINISH_DTYPE))


def _finish_ngtdm(acc, device):
    """``ngtdm_stats`` over the per-level counts and difference sums; the
    reference's default radius 0 leaves the neighbourhood empty and every
    member 0.0 (env_features.cpp:712-736, 3d_ngtdm.cpp:92-110)."""
    from ..ops import ngtdm as ngtdm2d
    if acc.cfg.d3_ngtdm_radius <= 0:
        return {m: 0.0 for m in NGTDM_MEMBERS}
    gi, _ = acc.grey("ngtdm")
    pres = np.array(acc.accs["ngtdm_present"])
    pres[0] = False
    return ovs._host(ngtdm2d.ngtdm_stats(
        ovs._dev(acc.accs["ngtdm_N"][None], device),
        ovs._dev(acc.accs["ngtdm_S"][None], device),
        ovs._dev(pres[None], device, torch.bool),
        ovs._dev([[[[acc.accs["ngtdm_maxlev"]]]]], device, torch.int32),
        ovs._dev([[[[True]]]], device, torch.bool), acc.cfg.noval,
        ovs.FINISH_DTYPE, ibsi=gi == 0))


# family -> its finish stage (acc, device) -> {member: value} or None
FINISH3D = {
    "D3_VoxelIntensityFeatures": _finish_intensity,
    "D3_GLCM_feature": _finish_glcm,
    "D3_GLRLM_feature": _finish_glrlm,
    "D3_GLSZM_feature": _finish_glszm,
    "D3_GLDZM_feature": _finish_gldzm,
    "D3_GLDM_feature": _finish_gldm,
    "D3_NGLDM_feature": _finish_ngldm,
    "D3_NGTDM_feature": _finish_ngtdm,
}


def process3d(rec, intens, labels, cfg, families, smin, smax, device="cpu"):
    """Streamed oversized pass for one 3D ROI: ``accumulate3d``, then each
    wanted family's finish stage on ``device`` (a torch device; the CPU
    only when the caller asks for it) and the host surface members.
    Returns {family: {member: val}}."""
    acc = accumulate3d(rec, intens, labels, cfg, families, smin, smax)
    out = {}
    for fam, finish in FINISH3D.items():
        if fam in acc.want:
            res = finish(acc, device)
            if res is not None:
                out[fam] = res
    if acc.surf is not None and acc.surf["n"]:
        out["D3_SurfaceFeature"] = _surface_members(rec, acc.surf)
    return out


def _surface_members(rec, surf):
    """D3_SurfaceFeature from streamed sums (mirrors
    runner3d.VolumeRunner._surface)."""
    n = surf["n"]
    out = {}
    ball_r3 = 1.0 / 8.0
    out["VOXEL_VOLUME"] = n * (4.0 / 3.0 * math.pi * ball_r3) / 0.5236
    out["AREA"] = float(surf["faces"])
    try:
        from scipy.spatial import ConvexHull
        pts = np.concatenate(surf["hull_pts"])
        hull = ConvexHull(pts)
        out["VOLUME_CONVEXHULL"] = hull.volume
    except Exception:
        out["VOLUME_CONVEXHULL"] = 0.0
    out["MESH_VOLUME"] = out["VOLUME_CONVEXHULL"]
    vv = out["VOXEL_VOLUME"]
    a = out["AREA"]
    out["AREA_2_VOLUME"] = a / vv
    out["COMPACTNESS1"] = vv / math.sqrt(math.pi * a ** 3) if a else 0.0
    out["COMPACTNESS2"] = 36 * math.pi * vv * vv / a ** 3 if a else 0.0
    out["SPHERICAL_DISPROPORTION"] = a / (36 * math.pi * vv * vv) ** (1 / 3)
    out["SPHERICITY"] = (36 * math.pi * vv * vv) ** (1 / 3) / a if a else 0.0
    # covariance from streamed first/second moments (bias=False)
    s, ss = surf["s"], surf["ss"]
    if n > 1:
        C = (ss - np.outer(s, s) / n) / (n - 1)
    else:
        C = np.zeros((3, 3))
    try:
        L = np.sort(np.linalg.eigvalsh(C))[::-1]
        if np.all(np.isfinite(L)) and L[0] > 0:
            out["MAJOR_AXIS_LEN"] = 4 * math.sqrt(max(L[0], 0))
            out["MINOR_AXIS_LEN"] = 4 * math.sqrt(max(L[1], 0))
            out["LEAST_AXIS_LEN"] = 4 * math.sqrt(max(L[2], 0))
            out["ELONGATION"] = math.sqrt(max(L[1], 0) / L[0])
            out["FLATNESS"] = math.sqrt(max(L[2], 0) / L[0])
        else:
            raise ValueError
    except Exception:
        for k in ("MAJOR_AXIS_LEN", "MINOR_AXIS_LEN", "LEAST_AXIS_LEN",
                  "ELONGATION", "FLATNESS"):
            out[k] = 0.0
    return out
