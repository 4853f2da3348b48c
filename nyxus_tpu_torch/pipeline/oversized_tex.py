# Copied verbatim from nyxus_tpu/pipeline/oversized_tex.py; pinned by tests/test_torch_tables.py.
"""Tile-streamed texture accumulators for oversized ROIs.

The reference runs every texture feature's ``osized_calculate`` over
file-backed pixel clouds (reference: src/nyx/phase3.cpp:94-114,
features/image_matrix_nontriv.h:9-72).  The TPU-native equivalent streams
the ROI's AABB once (twice for GLDZM) in full-width row strips, accumulating
exactly the small sufficient statistics each family's FEATURE math needs --
co-occurrence / run / zone / dependence matrices -- then reuses the SAME
jitted feature kernels as the dense (trivial) path so the feature math
cannot diverge:

* GLCM     -> count matrices per angle      -> ops.glcm.glcm_features_from_matrix
* GLRLM    -> run histograms per direction  -> ops.glrlm.glrlm_features
* GLSZM    -> zone (level, size) list       -> ops.glszm.glszm_features_from_zones
* GLDZM    -> zone (level, min dist) list   -> ops.gldzm.gldzm_features_from_zones
* GLDM     -> dependence matrix             -> ops.gldm.gldm_features
* NGLDM    -> dependence matrix             -> ops.ngldm.ngldm_features_from_matrix
* NGTDM    -> per-level N / S / present     -> ops.ngtdm.ngtdm_stats

Zone semantics replicate ops/zones.py: GLSZM zones are the reference's
forward E/SE/S/SW min-ancestor scan (glszm.cpp:89-160) computed as an exact
one-pass raster DP (every DAG predecessor -- W, NW, N, NE -- precedes its
successor in raster order, so the sequential DP needs no fixpoint
iteration); GLDZM zones are full 4-connected components (gldzm.cpp:121-210)
labeled by streaming union-find, with the min-border distance split into a
forward (left/right/top) and a vertically-flipped (bottom) pass joined on
the zone's canonical min-raster-index id (min distributes over the split:
min_p min(a_p, b_p) = min(min_p a_p, min_p b_p)).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

_HUGE = np.int64(1) << 60
_LEN_BITS = 31          # composite (level, run length) packing


# ---------------------------------------------------------------------------
# numpy mirror of ops.quant binning (must stay in lockstep)

def bin_levels_np(x: np.ndarray, vmin: float, vmax: float, greyinfo: int):
    """ops.quant.bin_levels on host arrays (int64 levels)."""
    if greyinfo > 0:
        slope = greyinfo / max(vmax, 1e-30)
        y = np.floor(slope * x + 1.0).astype(np.int64)
        y = np.clip(y, 1, greyinfo)
        return np.where(x == 0, 1, y)
    if greyinfo < 0:
        n = -greyinfo
        binw = (vmax - vmin) / n
        y = (np.floor((x - vmin) / max(binw, 1e-30)) + 1).astype(np.int64)
        y = np.minimum(y, n)
        return np.where(x == 0, 0, y)
    return x.astype(np.int64)


def _shift_cols(a: np.ndarray, dx: int, fill=0):
    """out[..., x] = a[..., x + dx] with constant fill outside."""
    if dx == 0:
        return a
    out = np.full_like(a, fill)
    if dx > 0:
        out[..., :-dx] = a[..., dx:]
    else:
        out[..., -dx:] = a[..., :dx]
    return out


def _seg_cummin(a: np.ndarray, conn: np.ndarray):
    """Segmented prefix-min along the last axis: min over a[j..i] with j the
    start of i's segment (conn[x] True = x joins x-1's segment).
    Hillis-Steele doubling, O(W log W) vectorized."""
    out = a.copy()
    reach = conn.copy()
    shift = 1
    n = a.shape[-1]
    while shift < n and reach.any():
        prev = np.full_like(out, _HUGE)
        prev[..., shift:] = out[..., :-shift]
        out = np.where(reach, np.minimum(out, prev), out)
        r2 = np.zeros_like(reach)
        r2[..., shift:] = reach[..., :-shift]
        reach = reach & r2
        shift <<= 1
    return out


def _row_runs(lv: np.ndarray):
    """(starts, ends, levels) of maximal equal-value runs of a row."""
    W = lv.shape[0]
    change = np.empty(W, bool)
    change[0] = True
    np.not_equal(lv[1:], lv[:-1], out=change[1:])
    starts = np.nonzero(change)[0]
    ends = np.append(starts[1:], W)
    return starts, ends, lv[starts]


# ---------------------------------------------------------------------------
# GLCM

class GlcmAccum:
    """Pair counts per angle (neighbor level - 1, center level - 1); a pair
    is valid iff BOTH original intensities > 0 (glcm.cpp:443-449).  Feed
    full-width row strips top-down."""

    ANGLE_OFFSETS = {0: (1, 0), 45: (1, 1), 90: (0, 1), 135: (-1, 1)}

    def __init__(self, angles, offset: int, ng: int):
        self.angles = tuple(angles)
        self.d = offset
        self.ng = ng
        self.M = {a: np.zeros((ng, ng), np.float64) for a in self.angles}
        self._carry = None      # last d rows (orig, lev), dy-pairs pending
        # present-level mask from PIXELS (not pairs): radiomics rank
        # compaction uses the unique-level set of the ROI's pixels
        self.present = np.zeros(ng, bool)

    def _count(self, ang, co, cl, no, nl):
        valid = (co > 0) & (no > 0)
        if not valid.any():
            return
        idx = (nl[valid] - 1) * self.ng + (cl[valid] - 1)
        self.M[ang] += np.bincount(
            idx.astype(np.int64), minlength=self.ng * self.ng
        ).reshape(self.ng, self.ng).astype(np.float64)

    def feed(self, orig: np.ndarray, lev: np.ndarray):
        d = self.d
        part = orig > 0
        if part.any():
            self.present[np.unique(lev[part].astype(np.int64)) - 1] = True
        # horizontal (dy == 0) pairs: complete within the new rows only
        for ang in self.angles:
            dx, dy = self.ANGLE_OFFSETS[ang]
            if dy != 0:
                continue
            self._count(ang, orig, lev, _shift_cols(orig, dx * d),
                        _shift_cols(lev, dx * d))
        # vertical/diagonal (dy == d) pairs: center rows need d rows below
        if self._carry is not None:
            co_all = np.concatenate([self._carry[0], orig], axis=0)
            cl_all = np.concatenate([self._carry[1], lev], axis=0)
        else:
            co_all, cl_all = orig, lev
        k = co_all.shape[0]
        if k > d:
            for ang in self.angles:
                dx, dy = self.ANGLE_OFFSETS[ang]
                if dy == 0:
                    continue
                self._count(ang, co_all[:-d], cl_all[:-d],
                            _shift_cols(co_all[d:], dx * d),
                            _shift_cols(cl_all[d:], dx * d))
            self._carry = (co_all[-d:].copy(), cl_all[-d:].copy())
        else:
            self._carry = (co_all.copy(), cl_all.copy())

    def finish(self, symmetric: bool):
        # rows still carried have no rows below: their dy-pairs fall outside
        # the AABB and are invalid (dense path: zero padding -> orig == 0)
        out = np.stack([self.M[a] for a in self.angles], axis=0)
        if symmetric:
            out = out + np.swapaxes(out, -1, -2)
        return out[None]    # [1, A, ng, ng]


# ---------------------------------------------------------------------------
# GLRLM

class RunAccum:
    """Maximal-run histograms for angles 0/45/90/135 (ops/glrlm.py
    semantics).  Horizontal runs complete within a row; vertical / diagonal
    runs carry (level, length) state per column: the successor of (y, x) is
    (y+1, x) for 90 deg, (y+1, x+1) for 45, (y+1, x-1) for 135."""

    _ORDER = {0: 0, 45: 1, 90: 2, 135: 3}

    def __init__(self, ng: int, width: int):
        self.ng = ng
        self.counts = Counter()     # (angle, level, length) -> n
        self.max_len = 1
        z = np.zeros(width, np.int64)
        self._st = {a: (z.copy(), z.copy()) for a in (45, 90, 135)}

    def _flush(self, ang, lev_arr, len_arr):
        sel = lev_arr > 0
        if not sel.any():
            return
        lv, ln = lev_arr[sel], len_arr[sel]
        self.max_len = max(self.max_len, int(ln.max()))
        comp = (lv << _LEN_BITS) + ln
        u, c = np.unique(comp, return_counts=True)
        for k, n in zip(u.tolist(), c.tolist()):
            self.counts[(ang, k >> _LEN_BITS, k & ((1 << _LEN_BITS) - 1))] += n

    def feed_row(self, lev_row: np.ndarray, valid_row: np.ndarray):
        W = lev_row.shape[0]
        lv = np.where(valid_row, lev_row, 0).astype(np.int64)

        # angle 0: horizontal runs, complete within the row
        starts, ends, rl = _row_runs(lv)
        sel = rl > 0
        if sel.any():
            self._flush(0, rl[sel], (ends - starts)[sel])

        for ang, shift in ((90, 0), (45, 1), (135, -1)):
            cl, cn = self._st[ang]
            if shift:
                pl = _shift_cols(cl, -shift, 0)   # state arrives at x+shift
                pn = _shift_cols(cn, -shift, 0)
                # runs shifted off the row edge terminate
                if shift > 0:
                    self._flush(ang, cl[-shift:], cn[-shift:])
                else:
                    self._flush(ang, cl[:-shift], cn[:-shift])
            else:
                pl, pn = cl, cn
            cont = (lv > 0) & (pl == lv)
            ended = (pl > 0) & ~cont
            self._flush(ang, np.where(ended, pl, 0), pn)
            self._st[ang] = (lv.copy(),
                             np.where(cont, pn + 1, (lv > 0).astype(np.int64)))

    def finish(self):
        for ang in (45, 90, 135):
            cl, cn = self._st[ang]
            self._flush(ang, cl, cn)
        nr = self.max_len
        P = np.zeros((1, 4, self.ng, nr), np.float64)
        for (ang, lv, ln), n in self.counts.items():
            P[0, self._ORDER[ang], lv - 1, min(ln, nr) - 1] += n
        return P


# ---------------------------------------------------------------------------
# GLSZM

class SzAccum:
    """Zone (level, size) list via the exact raster DP for the reference's
    forward E/SE/S/SW zone scan (see module docstring)."""

    def __init__(self, width: int):
        self.sizes: dict = {}        # anc raster id -> pixel count
        self.levels: dict = {}       # anc raster id -> level
        self._W = width
        self._prev = (np.full(width, _HUGE), np.zeros(width, np.int64),
                      np.zeros(width, bool))
        self._y = 0
        # per-row zone fragments buffer, compacted in blocks: the per-row
        # python dict loop dominated the giant-ROI sweep
        self._buf_anc: list = []
        self._buf_lev: list = []
        self._buf_n = 0

    def _compact(self):
        if not self._buf_anc:
            return
        av = np.concatenate(self._buf_anc)
        lv = np.concatenate(self._buf_lev)
        self._buf_anc.clear()
        self._buf_lev.clear()
        self._buf_n = 0
        u, first = np.unique(av, return_index=True)
        cnt = np.bincount(np.searchsorted(u, av))
        ul = lv[first]
        sizes, levels = self.sizes, self.levels
        for a_val, l_val, n in zip(u.tolist(), ul.tolist(), cnt.tolist()):
            sizes[a_val] = sizes.get(a_val, 0) + n
            if a_val not in levels:
                levels[a_val] = l_val

    def feed_row(self, lev_row: np.ndarray, valid_row: np.ndarray):
        W = self._W
        y = self._y
        lv = lev_row.astype(np.int64)
        ridx = np.int64(y) * W + np.arange(W, dtype=np.int64)
        anc = np.where(valid_row, ridx, _HUGE)
        p_anc, p_lev, p_val = self._prev
        for dx in (-1, 0, 1):        # NW, N, NE predecessors
            n_anc = _shift_cols(p_anc, dx, _HUGE)
            n_lev = _shift_cols(p_lev, dx, np.int64(-1))
            n_val = _shift_cols(p_val, dx, False)
            ok = valid_row & n_val & (n_lev == lv)
            anc = np.where(ok, np.minimum(anc, n_anc), anc)
        conn = np.zeros(W, bool)
        conn[1:] = valid_row[1:] & valid_row[:-1] & (lv[1:] == lv[:-1])
        anc = _seg_cummin(anc, conn)

        if valid_row.any():
            av = anc[valid_row]
            self._buf_anc.append(av)
            self._buf_lev.append(lv[valid_row])
            self._buf_n += len(av)
            if self._buf_n >= (1 << 19):
                self._compact()
        self._prev = (anc, lv, valid_row.copy())
        self._y += 1

    def finish(self):
        """(zlev [1, Z], zsize [1, Z], w [1, Z]) zone arrays (Z >= 1)."""
        self._compact()
        if not self.sizes:
            z = np.zeros((1, 1))
            return z, z.copy(), z.copy()
        ancs = sorted(self.sizes)
        zlev = np.asarray([self.levels[a] for a in ancs], np.float64)
        zsize = np.asarray([self.sizes[a] for a in ancs], np.float64)
        return zlev[None], zsize[None], np.ones_like(zlev)[None]


# ---------------------------------------------------------------------------
# GLDZM

class _UnionFind:
    __slots__ = ("parent",)

    def __init__(self):
        self.parent = []

    def make(self):
        self.parent.append(len(self.parent))
        return len(self.parent) - 1

    def find(self, x):
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a, b):
        """Returns the surviving root (the smaller id)."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if rb < ra:
            ra, rb = rb, ra
        self.parent[rb] = ra
        return ra


class DzAccum:
    """One GLDZM half-pass: 4-connected equal-level components by streaming
    union-find, tracking per zone (canonical min-raster id, level, min over
    pixels of min(d_left, d_right, d_up) + 1), distances stopping at
    zero-level pixels or the AABB margin (gldzm.cpp:306-352).  Run once
    top-down and once bottom-up (d_up of the flipped pass = d_down); join
    the per-zone minima on the canonical id."""

    def __init__(self, width: int):
        self.uf = _UnionFind()
        self.info: dict = {}        # root -> [canon_id, level, min_dist]
        self._W = width
        self._prev_runs: list = []  # (start, end, level, root), sorted
        self._last_zero = np.full(width, -1, np.int64)
        self._y = 0

    def feed_row(self, lev_row: np.ndarray, valid_row: np.ndarray,
                 orig_y: int):
        """orig_y: the row's y in the ORIGINAL (unflipped) frame."""
        W = self._W
        y = self._y
        lv = np.where(valid_row, lev_row.astype(np.int64), -1)

        xs = np.arange(W, dtype=np.int64)
        # distance stoppers: zero-LEVEL pixels; the dense kernel folds
        # non-participating pixels into level 0 too (registry passes
        # where(valid, levels, 0) to border_distance), so lv = -1 counts
        zero = lv <= 0
        NEG = np.int64(-(1 << 40))
        POS = np.int64(1 << 40)
        zl = np.maximum.accumulate(np.where(zero, xs, NEG))
        zl_prev = np.concatenate([[NEG], zl[:-1]])        # strictly left
        zr = np.minimum.accumulate(np.where(zero, xs, POS)[::-1])[::-1]
        zr_next = np.concatenate([zr[1:], [POS]])         # strictly right
        d_l = np.minimum(xs - zl_prev, xs)
        d_r = np.minimum(zr_next - xs, (W - 1) - xs)
        d_t = np.minimum(y - self._last_zero, y)          # strictly above
        dist = np.maximum(np.minimum(np.minimum(d_l, d_r), d_t) + 1, 1)

        runs = []
        if valid_row.any():
            starts, ends, rl = _row_runs(lv)
            for s, e, l in zip(starts.tolist(), ends.tolist(), rl.tolist()):
                if l < 0:
                    continue
                root = self.uf.make()
                self.info[root] = [np.int64(orig_y) * (1 << 40) + s, l,
                                   int(dist[s:e].min())]
                runs.append([s, e, l, root])

        # merge with previous row's runs on column overlap (4-connectivity)
        pi = 0
        prev = self._prev_runs
        for run in runs:
            s, e, l, root = run
            while pi < len(prev) and prev[pi][1] <= s:
                pi += 1
            pj = pi
            while pj < len(prev) and prev[pj][0] < e:
                ps, pe, plv, proot = prev[pj]
                if plv == l:
                    ra = self.uf.find(run[3])
                    rb = self.uf.find(proot)
                    if ra != rb:
                        ia, ib = self.info.pop(ra), self.info.pop(rb)
                        r = self.uf.union(ra, rb)
                        self.info[r] = [min(ia[0], ib[0]), l,
                                        min(ia[2], ib[2])]
                        run[3] = r
                pj += 1
        self._prev_runs = [(s, e, l, self.uf.find(r)) for s, e, l, r in runs]
        self._last_zero = np.where(zero, y, self._last_zero)
        self._y += 1

    def finish(self):
        """{canonical id: (level, min partial distance)} over live roots."""
        out = {}
        for root, (canon, lev, md) in self.info.items():
            if self.uf.find(root) == root:
                out[int(canon)] = (lev, md)
        return out


def _run_rle(lv: np.ndarray):
    """Vectorized RLE of a 2D level plane into row-confined maximal runs.
    Returns (starts, ends, rows, cols0, cole, rlev) -- flat indices, row ids,
    column intervals [cols0, cole), and levels."""
    H, W = lv.shape
    flat = lv.ravel()
    n = flat.size
    brk = np.empty(n, bool)
    brk[0] = True
    np.not_equal(flat[1:], flat[:-1], out=brk[1:])
    brk[::W] = True
    starts = np.nonzero(brk)[0]
    ends = np.append(starts[1:], n)
    rows = starts // W
    cols0 = starts - rows * W
    cole = ends - rows * W
    return starts, ends, rows, cols0, cole, flat[starts]


def _run_components(rows, cols0, cole, rlev, W):
    """Connected-component labels of the run graph (4-connectivity between
    equal-level runs of consecutive rows with overlapping column spans).
    Vectorized: overlap edges via searchsorted over the raster-ordered run
    list, then min-label propagation with pointer doubling."""
    nr = rows.shape[0]
    key_s = rows * np.int64(W) + cols0
    key_e = rows * np.int64(W) + cole
    # for each run j, candidate predecessors in row-1 with col overlap
    lo = np.searchsorted(key_e, (rows - 1) * np.int64(W) + cols0, "right")
    hi = np.searchsorted(key_s, (rows - 1) * np.int64(W) + cole, "left")
    cnt = np.maximum(hi - lo, 0)
    tot = int(cnt.sum())
    if tot:
        a = np.repeat(np.arange(nr, dtype=np.int64), cnt)
        csum = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        b = np.repeat(lo, cnt) + (np.arange(tot, dtype=np.int64)
                                  - np.repeat(csum, cnt))
        keep = rlev[a] == rlev[b]
        a, b = a[keep], b[keep]
    else:
        a = b = np.zeros(0, np.int64)
    label = np.arange(nr, dtype=np.int64)
    while True:
        l2 = label.copy()
        if a.size:
            np.minimum.at(l2, a, label[b])
            np.minimum.at(l2, b, label[a])
        l2 = np.minimum(l2, l2[l2])
        l2 = l2[l2]
        if np.array_equal(l2, label):
            break
        label = l2
    return label


def gldzm_zones_plane(lv: np.ndarray):
    """GLDZM zones of a full level plane in one vectorized pass -- the
    whole-ROI equivalent of the two DzAccum half-passes (4-connected
    equal-level components; per-zone min over pixels of the min border
    distance, distances stopping at zero-level pixels or the AABB margin,
    gldzm.cpp:121-210,306-352).

    ``lv``: int64 plane, invalid pixels -1 (they stop distances like level
    0 does and are excluded from zones).  Returns (zlev [Z], zdist [Z]) for
    zones with level > 0 (zone weight 1 each; aggregate before shipping)."""
    H, W = lv.shape
    zero = lv <= 0
    xs = np.arange(W, dtype=np.int32)[None, :]
    ys = np.arange(H, dtype=np.int32)[:, None]
    NEG = np.int32(-(1 << 30))
    POS = np.int32(1 << 30)
    # int32 throughout; intermediates freed eagerly (the plane path is
    # memory-gated by the caller, transients must stay a few planes deep)
    zl = np.maximum.accumulate(np.where(zero, xs, NEG), axis=1)
    zl[:, 1:] = zl[:, :-1]          # strictly-left zero
    zl[:, 0] = NEG
    dist = np.minimum(xs - zl, xs)                           # d_left
    del zl
    zr = np.minimum.accumulate(np.where(zero, xs, POS)[:, ::-1],
                               axis=1)[:, ::-1].copy()
    zr[:, :-1] = zr[:, 1:]          # strictly-right zero
    zr[:, -1] = POS
    np.minimum(dist, np.minimum(zr - xs, (W - 1) - xs), out=dist)
    del zr
    zt = np.maximum.accumulate(np.where(zero, ys, NEG), axis=0)
    zt[1:] = zt[:-1]                # strictly-above zero
    zt[0] = NEG
    np.minimum(dist, np.minimum(ys - zt, ys), out=dist)
    del zt
    zb = np.minimum.accumulate(np.where(zero, ys, POS)[::-1],
                               axis=0)[::-1].copy()
    zb[:-1] = zb[1:]                # strictly-below zero
    zb[-1] = POS
    np.minimum(dist, np.minimum(zb - ys, (H - 1) - ys), out=dist)
    del zb
    dist += 1
    np.maximum(dist, 1, out=dist)

    starts, ends, rows, cols0, cole, rlev = _run_rle(lv)
    run_min = np.minimum.reduceat(dist.ravel(), starts)
    label = _run_components(rows, cols0, cole, rlev, W)

    sel = rlev > 0
    if not sel.any():
        return np.zeros(0, np.float64), np.zeros(0, np.float64)
    u, inv = np.unique(label[sel], return_inverse=True)
    zmin = np.full(u.shape[0], np.int64(1) << 60)
    np.minimum.at(zmin, inv, run_min[sel])
    zlev = np.zeros(u.shape[0], np.int64)
    zlev[inv] = rlev[sel]      # same level across a zone; any writer works
    return zlev.astype(np.float64), zmin.astype(np.float64)


def join_dz(fwd: dict, bwd: dict):
    """(zlev [1, Z], zd [1, Z], wz [1, Z]) from the two half-passes.
    Only non-zero-level zones are counted (Ns, gldzm.cpp:418-421)."""
    keys = sorted(fwd)
    assert set(keys) == set(bwd), "GLDZM pass zone mismatch"
    zlev, zd = [], []
    for k in keys:
        lf, df = fwd[k]
        lb, db = bwd[k]
        if lf == 0:
            continue
        zlev.append(lf)
        zd.append(min(df, db))
    if not zlev:
        z = np.zeros((1, 1))
        return z, z.copy(), z.copy()
    zlev = np.asarray(zlev, np.float64)
    zd = np.asarray(zd, np.float64)
    return zlev[None], zd[None], np.ones_like(zlev)[None]


# ---------------------------------------------------------------------------
# NGTDM / GLDM / NGLDM (rolling 3-row neighborhood window)

class NeighborhoodAccum:
    """Feeds a rolling 3-row window into NGTDM (N, S, present), GLDM (P) and
    NGLDM (P) accumulators; each fed row becomes the center row exactly
    once."""

    def __init__(self, ng: int, nb_ngldm: int, want_ngtdm: bool,
                 want_gldm: bool, want_ngldm: bool):
        self.ng = ng
        self.nb = nb_ngldm
        self.want = (want_ngtdm, want_gldm, want_ngldm)
        self.N = np.zeros(ng + 1, np.float64)
        self.S = np.zeros(ng + 1, np.float64)
        self.present = np.zeros(ng + 1, bool)
        self.P_gldm = np.zeros((max(ng, 1), 9), np.float64)
        self.P_ngldm = np.zeros((nb_ngldm + 1, 9), np.float64)
        self._rows: list = []

    def _process(self, above, center, below):
        o, lev, valid, nglev = center
        W = o.shape[0]
        zrow = (np.zeros(W, np.float64), np.zeros(W, np.int64),
                np.zeros(W, bool), np.full(W, -1, np.int64))
        rows = [above if above is not None else zrow, center,
                below if below is not None else zrow]

        if self.want[0]:        # NGTDM
            lv = np.where(valid, lev, 0)
            nsum = np.zeros(W, np.float64)
            ncnt = np.zeros(W, np.float64)
            for ri, r in enumerate(rows):
                rlev = np.where(r[2], r[1], 0)
                for dx in (-1, 0, 1):
                    if ri == 1 and dx == 0:
                        continue
                    sl = _shift_cols(rlev, dx, np.int64(0))
                    ok = sl > 0
                    nsum += np.where(ok, sl, 0)
                    ncnt += ok
            isz = (lv > 0) & (ncnt > 0)
            if isz.any():
                ave = np.where(isz, nsum / np.maximum(ncnt, 1), 0.0)
                diff = np.abs(lv - ave)
                self.N += np.bincount(lv[isz],
                                      minlength=self.ng + 1)[:self.ng + 1]
                self.S += np.bincount(lv[isz], weights=diff[isz],
                                      minlength=self.ng + 1)[:self.ng + 1]
            if valid.any():
                self.present |= (np.bincount(
                    lv[valid], minlength=self.ng + 1)[:self.ng + 1] > 0)

        if self.want[1]:        # GLDM: validity by ORIGINAL intensity > 0
            roi = o > 0
            nd = np.ones(W, np.int64)
            for ri, r in enumerate(rows):
                r_roi = r[0] > 0
                for dx in (-1, 0, 1):
                    if ri == 1 and dx == 0:
                        continue
                    sroi = _shift_cols(r_roi, dx, False)
                    slev = _shift_cols(r[1], dx, np.int64(0))
                    nd += (sroi & (slev == lev)).astype(np.int64)
            if roi.any():
                idx = (lev[roi] - 1) * 9 + np.minimum(nd[roi], 9) - 1
                self.P_gldm += np.bincount(
                    idx, minlength=self.P_gldm.size
                ).reshape(self.P_gldm.shape).astype(np.float64)

        if self.want[2]:        # NGLDM: mask membership, to_grayscale levels
            m = nglev >= 0
            matches = np.zeros(W, np.int64)
            for ri, r in enumerate(rows):
                for dx in (-1, 0, 1):
                    if ri == 1 and dx == 0:
                        continue
                    sng = _shift_cols(r[3], dx, np.int64(-1))
                    matches += ((sng >= 0) & (sng == nglev)).astype(np.int64)
            if m.any():
                idx = nglev[m] * 9 + np.minimum(matches[m], 8)
                self.P_ngldm += np.bincount(
                    idx, minlength=self.P_ngldm.size
                ).reshape(self.P_ngldm.shape).astype(np.float64)

    def feed_row(self, orig, lev, valid, nglev):
        self._rows.append((orig, lev, valid, nglev))
        if len(self._rows) == 2:
            self._process(None, self._rows[0], self._rows[1])
        elif len(self._rows) == 3:
            self._process(*self._rows)
            self._rows.pop(0)

    # -- block-vectorized equivalent of repeated feed_row ------------------

    def _process2d(self, P, i0, i1, zplane):
        """Process centers P[*][i0:i1] with above plane P[*][i0-1:i1-1]
        (zero-padded at the top boundary) and below plane P[*][i0+1:i1+1]
        (zero-padded at the bottom).  P = (orig, lev, valid, nglev) stacks;
        zplane supplies the boundary rows."""
        o, lev, valid, nglev = (p[i0:i1] for p in P)
        M, W = o.shape

        def plane(off):
            lo, hi = i0 + off, i1 + off
            out = []
            for pi, p in enumerate(P):
                if lo >= 0 and hi <= P[0].shape[0]:
                    out.append(p[lo:hi])
                else:
                    q = np.empty((M, W), p.dtype)
                    srclo, dstlo = max(lo, 0), max(-lo, 0)
                    srchi = min(hi, P[0].shape[0])
                    n = srchi - srclo
                    if dstlo:
                        q[:dstlo] = zplane[pi]
                    q[dstlo:dstlo + n] = p[srclo:srchi]
                    if dstlo + n < M:
                        q[dstlo + n:] = zplane[pi]
                    out.append(q)
            return tuple(out)

        rows = [plane(-1), (o, lev, valid, nglev), plane(1)]

        if self.want[0]:        # NGTDM
            lv = np.where(valid, lev, 0)
            nsum = np.zeros((M, W), np.float64)
            ncnt = np.zeros((M, W), np.float64)
            for ri, r in enumerate(rows):
                rlev = np.where(r[2], r[1], 0)
                for dx in (-1, 0, 1):
                    if ri == 1 and dx == 0:
                        continue
                    sl = _shift_cols(rlev, dx, np.int64(0))
                    ok = sl > 0
                    nsum += np.where(ok, sl, 0)
                    ncnt += ok
            isz = (lv > 0) & (ncnt > 0)
            if isz.any():
                ave = np.where(isz, nsum / np.maximum(ncnt, 1), 0.0)
                diff = np.abs(lv - ave)
                self.N += np.bincount(lv[isz],
                                      minlength=self.ng + 1)[:self.ng + 1]
                self.S += np.bincount(lv[isz], weights=diff[isz],
                                      minlength=self.ng + 1)[:self.ng + 1]
            if valid.any():
                self.present |= (np.bincount(
                    lv[valid], minlength=self.ng + 1)[:self.ng + 1] > 0)

        if self.want[1]:        # GLDM: validity by ORIGINAL intensity > 0
            roi = o > 0
            nd = np.ones((M, W), np.int64)
            for ri, r in enumerate(rows):
                r_roi = r[0] > 0
                for dx in (-1, 0, 1):
                    if ri == 1 and dx == 0:
                        continue
                    sroi = _shift_cols(r_roi, dx, False)
                    slev = _shift_cols(r[1], dx, np.int64(0))
                    nd += (sroi & (slev == lev)).astype(np.int64)
            if roi.any():
                idx = (lev[roi] - 1) * 9 + np.minimum(nd[roi], 9) - 1
                self.P_gldm += np.bincount(
                    idx, minlength=self.P_gldm.size
                ).reshape(self.P_gldm.shape).astype(np.float64)

        if self.want[2]:        # NGLDM: mask membership, to_grayscale levels
            m = nglev >= 0
            matches = np.zeros((M, W), np.int64)
            for ri, r in enumerate(rows):
                for dx in (-1, 0, 1):
                    if ri == 1 and dx == 0:
                        continue
                    sng = _shift_cols(r[3], dx, np.int64(-1))
                    matches += ((sng >= 0) & (sng == nglev)).astype(np.int64)
            if m.any():
                idx = nglev[m] * 9 + np.minimum(matches[m], 8)
                self.P_ngldm += np.bincount(
                    idx, minlength=self.P_ngldm.size
                ).reshape(self.P_ngldm.shape).astype(np.float64)

    def feed_block(self, orig2d, lev2d, valid2d, nglev2d):
        """Feed a full-width row strip; equivalent to feed_row per row but
        vectorized over the strip (the above/below context of the strip's
        boundary rows is carried between calls; invariant shared with
        feed_row: _rows = [last centered row, pending row])."""
        W = orig2d.shape[1]
        blocks = (orig2d, lev2d, valid2d, nglev2d)
        tail = self._rows        # up to 2 carried 1-row tuples
        if tail:
            P = tuple(np.concatenate(
                [np.stack([t[i] for t in tail], axis=0), blocks[i]], axis=0)
                for i in range(4))
        else:
            P = blocks
        k = P[0].shape[0]
        zplane = (np.zeros((1, W), np.float64), np.zeros((1, W), np.int64),
                  np.zeros((1, W), bool), np.full((1, W), -1, np.int64))
        # centers: every stacked row whose below-row is now available;
        # with 2 carried rows the first is context only (already centered)
        i0 = 1 if len(tail) == 2 else 0
        i1 = k - 1
        if i1 > i0:
            self._process2d(P, i0, i1, zplane)
        self._rows = [tuple(np.ascontiguousarray(p[j]) for p in P)
                      for j in range(max(k - 2, 0), k)]

    def finish(self):
        if len(self._rows) == 1:
            self._process(None, self._rows[0], None)
        elif len(self._rows) == 2:
            self._process(self._rows[0], self._rows[1], None)
        self._rows = []
