"""3D pipeline (PyTorch port of nyxus_tpu/pipeline/runner3d.py): volume ROI
discovery, bucketed [B, D, H, W] batching, the eight device families
``D3_*`` on one torch device, or with each bucket's ROI axis sharded over
several (``devices=``; nyxus_tpu/pipeline/runner3d.py:585-587, as
``runner.PairRunner`` shards its buckets), and the host surface family.

The run modes: ``mergerois``, whole-volume mode (one vROI over the
one-past box), 3D anisotropy (the nearest-neighbour resampled virtual
volume), lazy 2.5D layout-A stacks (per-plane discovery and host crop
assembly; the stack never materialises), and oversized ROIs over the RAM
gate (the slice-streamed phase 3 of pipeline/oversized3d.py, its finish
stages on this runner's device).

Reference: src/nyx/workflow_3d_segmented.cpp, phase1.cpp:248 (3D metrics
gather), phase2_3d.cpp (SimpleCube build), reduce_trivial_rois.cpp (3D
families).  ``Roi3D``, ``_aniso_bbox3``, ``discover_rois_3d``,
``discover_rois_3d_streamed``, ``VolumeRunner._surface`` and
``VolumeRunner._surface_wholevolume`` are verbatim copies of the JAX
package's code (pinned by tests/test_torch_tables.py).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from .. import columns as col
from .. import taxonomy as tx
from ..config import EngineConfig
from ..ops import common as ops_common
from ..ops import intensity as ops_intensity
from ..ops import quant
from ..ops import texture3d as t3
from ..parallel import device_guard, partition
from . import batching
from .oversized3d import is_oversized3d, process3d

@dataclasses.dataclass
class Roi3D:
    label: int
    area: int
    z0: int; z1: int; y0: int; y1: int; x0: int; x1: int
    vmin: float
    vmax: float
    # fed-cloud voxel count when it differs from the physical aux area
    # (3D anisotropy: the virtual member count)
    cloud_area: int = None
    # texture grey-binning range override (whole-volume mode: the vROI's
    # aux_min/aux_max are 0 and slide_max - slide_min -- the Hounsfield-style
    # offset of featurize_wholevolume, workflow_3d_whole.cpp:102-106 -- while
    # the cube keeps RAW intensities, so binned levels can exceed the nominal
    # grey depth).  None -> bin with the cloud's vmin/vmax (segmented mode)
    bin_min: float = None
    bin_max: float = None

    @property
    def depth(self):
        return self.z1 - self.z0 + 1

    @property
    def height(self):
        return self.y1 - self.y0 + 1

    @property
    def width(self):
        return self.x1 - self.x0 + 1


def _aniso_bbox3(r: Roi3D, ax: float, ay: float, az: float) -> Roi3D:
    """3-axis AABB::apply_anisotropy (features/aabb.h:115-134): truncate the
    mins, truncate the maxes with the one-step round-trip fixup.  area/vmin/
    vmax keep their physical phase-1 values (aux_* quirk)."""
    def scale(lo, hi, a):
        lo2, hi2 = int(lo * a), int(hi * a)
        if int((hi2 + 1) / a) == hi:
            hi2 += 1
        return lo2, hi2
    x0, x1 = scale(r.x0, r.x1, ax)
    y0, y1 = scale(r.y0, r.y1, ay)
    z0, z1 = scale(r.z0, r.z1, az)
    return Roi3D(r.label, r.area, z0, z1, y0, y1, x0, x1, r.vmin, r.vmax)


def discover_rois_3d(intens: np.ndarray, labels: np.ndarray):
    D, H, W = labels.shape
    flat = labels.ravel()
    nz = flat != 0
    labs = flat[nz]
    if labs.size == 0:
        return [], float(intens.min(initial=0)), float(intens.max(initial=0))
    vals = intens.ravel()[nz].astype(np.float64)
    uniq, inv = np.unique(labs, return_inverse=True)
    k = uniq.size
    area = np.bincount(inv, minlength=k)
    vmin = np.full(k, np.inf); vmax = np.full(k, -np.inf)
    np.minimum.at(vmin, inv, vals)
    np.maximum.at(vmax, inv, vals)
    pos = np.nonzero(nz)[0]
    zz = pos // (H * W)
    yy = (pos // W) % H
    xx = pos % W
    lim = {}
    out = []
    for name, arr, red, init in (("z0", zz, np.minimum, D), ("z1", zz, np.maximum, -1),
                                 ("y0", yy, np.minimum, H), ("y1", yy, np.maximum, -1),
                                 ("x0", xx, np.minimum, W), ("x1", xx, np.maximum, -1)):
        acc = np.full(k, init, np.int64)
        red.at(acc, inv, arr)
        lim[name] = acc
    recs = [Roi3D(int(uniq[i]), int(area[i]),
                  int(lim["z0"][i]), int(lim["z1"][i]),
                  int(lim["y0"][i]), int(lim["y1"][i]),
                  int(lim["x0"][i]), int(lim["x1"][i]),
                  float(vmin[i]), float(vmax[i])) for i in range(k)]
    return recs, float(intens.min()), float(intens.max())


def discover_rois_3d_streamed(intens, labels):
    """Per-z-plane accumulation variant of discover_rois_3d for lazy
    (layout-A) stacks: one decoded plane in flight, identical results.
    Mirrors the reference's slice-streamed 2.5D phase 1
    (phase1.cpp:130 gatherRoisMetrics_25D)."""
    D, H, W = labels.shape
    agg = {}    # label -> [area, z0, z1, y0, y1, x0, x1, vmin, vmax]
    smin, smax = np.inf, -np.inf
    for z in range(D):
        lab2 = np.asarray(labels[z])
        int2 = np.asarray(intens[z])
        smin = min(smin, float(int2.min()))
        smax = max(smax, float(int2.max()))
        ys, xs = np.nonzero(lab2)
        if ys.size == 0:
            continue
        labs = lab2[ys, xs]
        vals = int2[ys, xs].astype(np.float64)
        uniq, inv = np.unique(labs, return_inverse=True)
        k = uniq.size
        area = np.bincount(inv, minlength=k)
        vmin = np.full(k, np.inf)
        vmax = np.full(k, -np.inf)
        np.minimum.at(vmin, inv, vals)
        np.maximum.at(vmax, inv, vals)
        y0 = np.full(k, H, np.int64)
        y1 = np.full(k, -1, np.int64)
        x0 = np.full(k, W, np.int64)
        x1 = np.full(k, -1, np.int64)
        np.minimum.at(y0, inv, ys)
        np.maximum.at(y1, inv, ys)
        np.minimum.at(x0, inv, xs)
        np.maximum.at(x1, inv, xs)
        for i in range(k):
            lb = int(uniq[i])
            a = agg.get(lb)
            if a is None:
                agg[lb] = [int(area[i]), z, z, int(y0[i]), int(y1[i]),
                           int(x0[i]), int(x1[i]), float(vmin[i]),
                           float(vmax[i])]
            else:
                a[0] += int(area[i])
                a[2] = z
                a[3] = min(a[3], int(y0[i]))
                a[4] = max(a[4], int(y1[i]))
                a[5] = min(a[5], int(x0[i]))
                a[6] = max(a[6], int(x1[i]))
                a[7] = min(a[7], float(vmin[i]))
                a[8] = max(a[8], float(vmax[i]))
    recs = [Roi3D(lb, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8])
            for lb, a in sorted(agg.items())]
    return recs, float(smin), float(smax)


class Ctx3D:
    """One bucket's batch on the device, with the derived tensors the
    families share cached (nyxus_tpu/pipeline/runner3d.py:162)."""

    def __init__(self, intens, mask, area, vmin, vmax, dd, hh, ww, cfg,
                 static_meta=(), slide_range=None, cloud_area=None,
                 bvmin=None, bvmax=None):
        self.slide_range = slide_range
        self.intens = intens
        self.mask = mask
        self.area = area
        self.cloud_area = area if cloud_area is None else cloud_area
        self.vmin = vmin
        self.vmax = vmax
        self.bvmin = vmin if bvmin is None else bvmin
        self.bvmax = vmax if bvmax is None else bvmax
        self.depths = dd
        self.heights = hh
        self.widths = ww
        self.cfg = cfg
        self.static_meta = dict(static_meta)
        self._cache = {}

    @property
    def B(self):
        return self.intens.shape[0]

    def cached(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def masked_intens(self):
        return self.cached("mi", lambda: torch.where(self.mask, self.intens,
                                                     0))

    @property
    def aabb(self):
        return self.cached("aabb", lambda: t3._in_aabb3d(
            self.intens.shape[1:], self.depths, self.heights, self.widths))

    def levels(self, greyinfo):
        return self.cached(("lev", greyinfo), lambda: quant.bin_levels(
            self.masked_intens, self.bvmin[:, None, None, None],
            self.bvmax[:, None, None, None], greyinfo))


def _grey(ctx, cfg, family=None):
    """(greyInfo, matrix size) of a family: a grey depth bins into that many
    levels; 0 (IBSI mode, and the per-family default of GLRLM/GLSZM/GLDM/
    NGTDM) keeps raw levels, with the matrix sized by the volume's
    power-of-two ceiling."""
    if cfg.ibsi:
        return 0, int(ctx.static_meta.get("max_int", 256))
    g = cfg.texture_greydepth3(family) if family else cfg.coarse_gray_depth
    if g == 0:
        return 0, int(ctx.static_meta.get("max_int", 256))
    return g, g


def _f_intensity(ctx, cfg):
    sv = ops_common.sort_masked_values(ctx.intens, ctx.mask)
    rng = (ctx.slide_range if ctx.slide_range is not None
           else torch.ones_like(ctx.vmin))
    return ops_intensity.pixel_intensity_features(
        sv, ctx.area, ctx.vmin, ctx.vmax, rng, cfg.coarse_gray_depth,
        cfg.noval)


def _f_glcm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "glcm")
    ng_val = ctx.bvmax if gi == 0 else None
    return t3.glcm3d_all(ctx.levels(gi), ctx.depths, ctx.heights, ctx.widths,
                         ctx.bvmin, ctx.bvmax, cfg.glcm3_offset, ng, gi == 0,
                         gi, cfg.noval, ctx.intens.dtype, ng_val)


def _f_glrlm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "glrlm")
    lev = ctx.levels(gi)
    valid = ctx.aabb if gi > 0 else (ctx.aabb & (lev > 0))
    # Np = fed-cloud voxel count (3d_glrlm.cpp:196 raw_pixels_3D.size())
    nr = max(ctx.intens.shape[1:])
    return t3.glrlm3d_all(lev, valid, ctx.cloud_area, ctx.bvmin, ctx.bvmax,
                          ng, nr, cfg.noval, ctx.intens.dtype)


def _f_glszm(ctx, cfg):
    gi, _ = _grey(ctx, cfg, "glszm")
    lev = ctx.levels(gi)
    zero_i = 1 if gi > 0 else 0
    valid = ctx.aabb & (lev != zero_i)
    # Np = fed-cloud voxel count (3d_glszm.cpp:529 raw_pixels_3D.size())
    return t3.glszm3d_all(torch.where(valid, lev, -1), valid, ctx.cloud_area,
                          ctx.bvmin, ctx.bvmax, cfg.noval, ctx.intens.dtype)


def _f_gldzm(ctx, cfg):
    gi, _ = _grey(ctx, cfg)   # no 3gldzm metaparam path exists
    lev = ctx.levels(gi)
    valid = ctx.aabb if gi > 0 else (ctx.aabb & (lev > 0))
    # GLDZM's Np is the physical area (3d_gldzm.cpp:547)
    return t3.gldzm3d_all(torch.where(ctx.aabb, lev, 0), valid, ctx.heights,
                          ctx.widths, ctx.area, ctx.bvmin, ctx.bvmax,
                          cfg.noval, ctx.intens.dtype)


def _f_gldm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "gldm")
    lev = ctx.levels(gi)
    zero_i = 1 if gi > 0 else 0
    return t3.gldm3d_all(torch.where(ctx.aabb, lev, -9), ctx.aabb, zero_i, ng,
                         ctx.bvmin, ctx.bvmax, cfg.noval, ctx.intens.dtype)


def _f_ngldm(ctx, cfg):
    gi, ng = _grey(ctx, cfg)
    dev = ctx.intens.device
    D, H, W = ctx.intens.shape[1:]
    zs = torch.arange(D, dtype=torch.int32, device=dev)[None, :, None, None]
    ys = torch.arange(H, dtype=torch.int32, device=dev)[None, None, :, None]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, None, :]
    interior = ((zs >= 1) & (zs < ctx.depths[:, None, None, None] - 1)
                & (ys >= 1) & (ys < ctx.heights[:, None, None, None] - 1)
                & (xs >= 1) & (xs < ctx.widths[:, None, None, None] - 1))
    n_levels = 0 if cfg.ibsi else cfg.coarse_gray_depth
    # to_grayscale is unclamped (helpers.h:337); "ngldm_nmax" carries the
    # host-computed level ceiling; IBSI's raw levels reach the slide max
    nmax = (int(ctx.static_meta.get("max_int", 256)) if cfg.ibsi
            else int(ctx.static_meta.get("ngldm_nmax", ng)))
    return t3.ngldm3d_all(ctx.masked_intens,
                          {"interior": interior, "inbounds": ctx.aabb},
                          ctx.bvmax, n_levels, nmax, cfg.ibsi,
                          ctx.bvmin, cfg.noval, ctx.intens.dtype)


NGTDM_MEMBERS = ("NGTDM_COARSENESS", "NGTDM_CONTRAST", "NGTDM_BUSYNESS",
                 "NGTDM_COMPLEXITY", "NGTDM_STRENGTH")


def _f_ngtdm(ctx, cfg):
    if cfg.d3_ngtdm_radius <= 0:
        # reference default: NGTDM_RADIUS is zero-initialised
        # (env_features.cpp:712-736), the Chebyshev neighbourhood is empty
        # and the binary emits 0.0 for all five members
        z = torch.zeros((ctx.B,), dtype=ctx.intens.dtype,
                        device=ctx.intens.device)
        return {m: z for m in NGTDM_MEMBERS}
    gi, ng = _grey(ctx, cfg, "ngtdm")
    lev = ctx.levels(gi)
    zero_i = 1 if gi > 0 else 0
    return t3.ngtdm3d_all(torch.where(ctx.aabb, lev, 0), ctx.aabb, zero_i, ng,
                          cfg.d3_ngtdm_radius, ctx.bvmin, ctx.bvmax,
                          cfg.noval, ctx.intens.dtype, ibsi=gi == 0)


FAMILIES3D = {
    "D3_VoxelIntensityFeatures": _f_intensity,
    "D3_GLCM_feature": _f_glcm,
    "D3_GLRLM_feature": _f_glrlm,
    "D3_GLSZM_feature": _f_glszm,
    "D3_GLDZM_feature": _f_gldzm,
    "D3_GLDM_feature": _f_gldm,
    "D3_NGLDM_feature": _f_ngldm,
    "D3_NGTDM_feature": _f_ngtdm,
}


class VolumeRunner:
    """Featurizes one (intensity, labels) 3D volume pair on ``device`` (a
    torch device; the CPU only when the caller asks for it), or with each
    bucket sharded over ``devices`` (a list from ``parallel.roi_devices``;
    the first is the primary device, where phase 3 runs)."""

    def __init__(self, fset: tx.FeatureSet, cfg: EngineConfig,
                 device="cuda", devices=None):
        self.fset = fset
        self.cfg = cfg
        self.devices = [torch.device(d) for d in devices] if devices \
            else [torch.device(device)]
        self.device = self.devices[0]
        self.dtype = torch.float64 if cfg.precision == "f64" else torch.float32
        self.families = tuple(
            n for n in FAMILIES3D
            if fset.any_enabled(tx.CLASS_FEATURES[n]))
        self.need_surface = fset.any_enabled(
            tx.CLASS_FEATURES["D3_SurfaceFeature"])
        _, self.slots = col.build_header(fset, cfg)
        self.n_values = sum(w for _, w in self.slots)
        self.member_slots = {}
        off = 0
        for code, width in self.slots:
            self.member_slots[code] = (off, width)
            off += width

    def run(self, intens, label_img, wholeslide: bool = False):
        """One [Z, Y, X] volume pair: numpy arrays, or the lazy channels of
        a layout-A stack (``sources.LayoutAStack``), which never
        materialise.  ``wholeslide``: the volume is one vROI.  Returns
        (labels[int], values[N, n_values]) in ascending label order;
        unassigned features hold -0.0."""
        # lazy (layout-A streamed) stacks: per-plane discovery, host-side
        # crop assembly, per-z oversized pass (reference: phase1.cpp:130,
        # phase2_25d.cpp)
        lazy = not isinstance(intens, np.ndarray)
        if lazy and (self.cfg.mergerois or self.cfg.aniso_customized
                     or abs(self.cfg.aniso_z - 1.0) > 1.2e-07):
            raise ValueError("streamed 2.5D stacks do not support "
                             "mergerois/anisotropy; raise ram_limit to "
                             "materialize the stack")
        if self.cfg.mergerois:
            # --mergerois: the whole nonzero foreground is one ROI
            label_img = (label_img != 0).astype(label_img.dtype)
        with record_function("nyx:discover"):
            recs, smin, smax = (discover_rois_3d_streamed(intens, label_img)
                                if lazy else
                                discover_rois_3d(intens, label_img))
        if wholeslide and len(recs) == 1:
            # whole-volume vROI: the inclusive one-past AABB 0..D, 0..H,
            # 0..W (init_from_whd, aabb.h:61-69), whose last plane, row and
            # column stay empty and take part as grey 0; the textures bin
            # against the vROI's aux range 0 .. slide_max - slide_min
            # (workflow_3d_whole.cpp:102-106)
            D, H, W = intens.shape
            r0 = recs[0]
            recs[0] = Roi3D(r0.label, r0.area, 0, D, 0, H, 0, W,
                            r0.vmin, r0.vmax,
                            bin_min=0.0, bin_max=float(int(smax - smin)))
        if self.cfg.aniso_customized or \
                abs(self.cfg.aniso_z - 1.0) > 1.1920929e-07:
            with record_function("nyx:aniso"):
                recs, intens, label_img = self._anisotropic(recs, intens,
                                                            label_img)
        n = len(recs)
        values = np.full((n, self.n_values), -0.0, np.float64)
        if n == 0:
            return np.zeros(0, np.int64), values

        # trivial/oversized triage (the reference's RAM gate; 3D phase 3
        # runs every family's osized_calculate, phase3.cpp:94-114)
        budget = self.cfg.ram_limit_mb << 20
        over = {i for i, r in enumerate(recs) if is_oversized3d(r, budget)}
        if over:
            with record_function("nyx:oversized"), \
                    device_guard(self.device):
                self._oversized(values, recs, over, intens, label_img, smin,
                                smax)

        buckets = collections.defaultdict(list)
        for i, r in enumerate(recs):
            if i not in over:
                buckets[(batching.pad_dim(r.depth), batching.pad_dim(r.height),
                         batching.pad_dim(r.width))].append(i)
        # volume-level power-of-two ceiling of the raw levels' matrices
        ceil = max(int(smax), 2)
        ceil = 1 << (ceil - 1).bit_length()
        outs = []
        for shape, idxs in sorted(buckets.items()):
            brecs = [recs[i] for i in idxs]
            # NGLDM level ceiling: to_grayscale is unclamped, so when a rec
            # bins against a range below its cloud max levels reach
            # floor(cloud_max * n / range)
            g_ngldm = 0 if self.cfg.ibsi else self.cfg.coarse_gray_depth
            ngldm_nmax = max(abs(g_ngldm), 2)
            for r in brecs:
                if r.bin_max is not None and r.bin_max < r.vmax and \
                        r.bin_max > 0 and g_ngldm > 0:
                    ngldm_nmax = max(ngldm_nmax,
                                     int(r.vmax * g_ngldm / r.bin_max) + 1)
            static_meta = (("max_int", ceil), ("ngldm_nmax", ngldm_nmax))
            # one shard a device (one shard: the whole bucket), each one's
            # crops, families and pack under its device
            for k, part in partition(len(idxs), len(self.devices)):
                dev = self.devices[k]
                with device_guard(dev):
                    outs.append((idxs[part],) + self._run_batch(
                        intens, label_img, brecs[part], shape, smax - smin,
                        static_meta, dev))

        # one device-to-host copy per volume and device
        by_dev = {}
        for o in outs:
            if o[2] is not None:
                by_dev.setdefault(o[2].device, []).append(o)
        for part in by_dev.values():
            with record_function("nyx:collect"):
                host = torch.cat([p.reshape(-1) for _, _, p in part]).cpu() \
                    .to(torch.float64).numpy()
            pos = 0
            for idxs, members, p in part:
                block = host[pos:pos + p.numel()].reshape(p.shape)
                pos += p.numel()
                rows = np.asarray(idxs)
                c = 0
                for code, w in members:
                    off, width = self.member_slots[code]
                    k = min(w, width)
                    values[rows, off:off + k] = block[:, c:c + k]
                    c += w

        if self.need_surface:
            with record_function("nyx:D3_SurfaceFeature"):
                if wholeslide and len(recs) == 1:
                    self._surface_wholevolume(values, recs[0])
                else:
                    self._surface(values, recs,
                                  _Windows(label_img) if lazy else label_img,
                                  skip=over)
        labs = np.asarray([r.label for r in recs], np.int64)
        return labs, values

    def _run_batch(self, intens, label_img, brecs, shape, srange,
                   static_meta, device):
        """Every 3D device family over one padded bucket (or one shard of
        it) on ``device``, which the caller has made current; returns
        (members [(code, width)], packed [B, total width] or None)."""
        with record_function("nyx:crops"):
            ctx = self._batch_context(intens, label_img, brecs, shape,
                                      srange, static_meta, device)
        out = {}
        for name in self.families:
            with record_function("nyx:" + name):
                out[name] = FAMILIES3D[name](ctx, self.cfg)
        with record_function("nyx:pack"):
            members, parts = [], []
            for members_of in out.values():
                for member, arr in members_of.items():
                    code = tx.F3D.get(member)
                    if code is None or code not in self.member_slots:
                        continue
                    a2 = arr[:, None] if arr.dim() == 1 else arr
                    members.append((code, a2.shape[1]))
                    parts.append(a2.to(self.dtype))
            return members, (torch.cat(parts, dim=1) if parts else None)

    def _anisotropic(self, recs, intens, label_img):
        """3D anisotropy: the physical phase-1 records mapped to the
        nearest-neighbour resampled virtual volume (reference:
        phase1.cpp:220-344 make_anisotropic_aabb, phase2_3d.cpp's
        anisotropic rescan).  Returns (records, virtual intensities,
        virtual labels)."""
        ax, ay, az = self.cfg.aniso_x, self.cfg.aniso_y, self.cfg.aniso_z
        recs = [_aniso_bbox3(r, ax, ay, az) for r in recs]
        D, H, W = intens.shape
        # the 3D virtual->physical map rounds (+0.5) and skips positions
        # beyond the physical bounds, leaving those virtual voxels empty,
        # unlike the 2D path's truncation and clamp
        # (scanTrivialRois_3D_anisotropic, phase2_3d.cpp:385-400)
        ps = (np.arange(int(D * az)) / az + 0.5).astype(np.int64)
        pr = (np.arange(int(H * ay)) / ay + 0.5).astype(np.int64)
        pc = (np.arange(int(W * ax)) / ax + 0.5).astype(np.int64)
        vi = np.zeros((len(ps), len(pr), len(pc)), intens.dtype)
        vl = np.zeros(vi.shape, label_img.dtype)
        okz, oky, okx = ps < D, pr < H, pc < W
        sub = np.ix_(okz, oky, okx)
        vi[sub] = intens[ps[okz]][:, pr[oky]][:, :, pc[okx]]
        vl[sub] = label_img[ps[okz]][:, pr[oky]][:, :, pc[okx]]
        # after the virtual rescan each AABB is the natural box of the fed
        # virtual voxels (aabb.update_from_voxelcloud, phase2_3d.cpp:
        # 695-699) and the voxel count the virtual cloud's (the run and
        # zone denominators); area, vmin and vmax stay physical
        vrecs, _, _ = discover_rois_3d(vi, vl)
        nat = {r.label: r for r in vrecs}
        recs = [Roi3D(r.label, r.area,
                      nat[r.label].z0, nat[r.label].z1,
                      nat[r.label].y0, nat[r.label].y1,
                      nat[r.label].x0, nat[r.label].x1,
                      r.vmin, r.vmax, cloud_area=nat[r.label].area)
                for r in recs if r.label in nat]
        return recs, vi, vl

    def _oversized(self, values, recs, rows, intens, label_img, smin, smax):
        """Phase 3: each row of ``rows`` through the slice-streamed pass of
        pipeline/oversized3d.py, its finish stages on this runner's
        device, scattered into ``values``."""
        fams = set(self.families)
        if self.need_surface:
            fams.add("D3_SurfaceFeature")
        for i in sorted(rows):
            res = process3d(recs[i], intens, label_img, self.cfg, fams, smin,
                            smax, device=self.device)
            for members in res.values():
                for member, v in members.items():
                    code = tx.F3D.get(member)
                    if code is None or code not in self.member_slots:
                        continue
                    off, width = self.member_slots[code]
                    arr = np.atleast_1d(np.asarray(v, np.float64))
                    w = min(width, arr.size)
                    values[i, off:off + w] = arr[:w]

    def _batch_context(self, intens, label_img, brecs, shape, srange,
                       static_meta, device=None):
        """Host crop assembly of one padded bucket, shipped to ``device``
        (the runner's by default) once.  A lazy stack's crops are cut plane by plane, the ROIs in
        the order of their first plane, so that its LRU of decoded planes
        serves each plane once where the ROIs allow."""
        D, H, W = shape
        B = len(brecs)
        np_dt = np.float64 if self.dtype == torch.float64 else np.float32
        ci = np.zeros((B, D, H, W), np_dt)
        cm = np.zeros((B, D, H, W), bool)
        Z_, Y_, X_ = label_img.shape
        lazy = not isinstance(intens, np.ndarray)
        for bi in sorted(range(B), key=lambda b: brecs[b].z0):
            r = brecs[bi]
            z1 = min(r.z0 + D, Z_)
            y1 = min(r.y0 + H, Y_)
            x1 = min(r.x0 + W, X_)
            if lazy:
                sl = (slice(r.y0, y1), slice(r.x0, x1))
                for z in range(r.z0, z1):
                    ci[bi, z - r.z0, :y1 - r.y0, :x1 - r.x0] = \
                        np.asarray(intens[z])[sl]
                    cm[bi, z - r.z0, :y1 - r.y0, :x1 - r.x0] = \
                        np.asarray(label_img[z])[sl] == r.label
                continue
            sl = (slice(r.z0, z1), slice(r.y0, y1), slice(r.x0, x1))
            ci[bi, :z1 - r.z0, :y1 - r.y0, :x1 - r.x0] = intens[sl]
            cm[bi, :z1 - r.z0, :y1 - r.y0, :x1 - r.x0] = label_img[sl] == r.label
        meta_i = np.asarray([[r.area, r.depth, r.height, r.width,
                              r.area if r.cloud_area is None else r.cloud_area]
                             for r in brecs], np.int32)
        meta_f = np.asarray([[r.vmin, r.vmax,
                              r.vmin if r.bin_min is None else r.bin_min,
                              r.vmax if r.bin_max is None else r.bin_max,
                              srange] for r in brecs], np_dt)
        dev = self.device if device is None else device
        mi = torch.from_numpy(meta_i).to(dev)
        mf = torch.from_numpy(meta_f).to(dev)
        return Ctx3D(torch.from_numpy(ci).to(dev), torch.from_numpy(cm).to(dev),
                     mi[:, 0], mf[:, 0], mf[:, 1], mi[:, 1], mi[:, 2],
                     mi[:, 3], self.cfg, static_meta, slide_range=mf[:, 4],
                     cloud_area=mi[:, 4], bvmin=mf[:, 2], bvmax=mf[:, 3])

    def _surface_wholevolume(self, values, r):
        """singleROI surface members: analytic box quantities from the
        one-past AABB dims; axis features zeroed
        (3d_surface.cpp:330-352)."""
        import math
        w, h, d = float(r.width), float(r.height), float(r.depth)
        area = 2.0 * (w * h + h * d + w * d)
        vol = w * h * d
        out = {
            "AREA": area, "VOLUME_CONVEXHULL": vol, "VOXEL_VOLUME": vol,
            "MESH_VOLUME": vol, "AREA_2_VOLUME": area / vol,
            "COMPACTNESS1": vol / math.sqrt(math.pi * area ** 3),
            "COMPACTNESS2": 36.0 * math.pi * vol * vol / area ** 3,
            "SPHERICAL_DISPROPORTION":
                area / (36.0 * math.pi * vol * vol) ** (1.0 / 3.0),
            "SPHERICITY":
                (36.0 * math.pi * vol * vol) ** (1.0 / 3.0) / area,
            "MAJOR_AXIS_LEN": 0.0, "MINOR_AXIS_LEN": 0.0,
            "LEAST_AXIS_LEN": 0.0, "ELONGATION": 0.0, "FLATNESS": 0.0,
        }
        for member, v in out.items():
            code = tx.F3D.get(member)
            if code is not None and code in self.member_slots:
                off, _ = self.member_slots[code]
                values[0, off] = v

    def _surface(self, values, recs, label_img, skip=frozenset()):
        """D3_SurfaceFeature host computation (3d_surface.cpp:?)."""
        import math
        from scipy.spatial import ConvexHull, QhullError

        for i, r in enumerate(recs):
            if i in skip:   # oversized rows: streamed in oversized3d
                continue
            m = label_img[r.z0:r.z1 + 1, r.y0:r.y1 + 1, r.x0:r.x1 + 1] == r.label
            zz, yy, xx = np.nonzero(m)
            n = len(zz)
            if n == 0:
                continue
            out = {}
            ball_r3 = 1.0 / 8.0
            out["VOXEL_VOLUME"] = n * (4.0 / 3.0 * math.pi * ball_r3) / 0.5236
            # exposed faces (6-neighborhood)
            pm = np.pad(m, 1)
            area = 0
            for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                               (0, 0, 1), (0, 0, -1)):
                nb = pm[1 + dz:1 + dz + m.shape[0], 1 + dy:1 + dy + m.shape[1],
                        1 + dx:1 + dx + m.shape[2]]
                area += int((m & ~nb).sum())
            out["AREA"] = float(area)
            pts = np.stack([xx + r.x0, yy + r.y0, zz + r.z0], 1).astype(float)
            try:
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
            C = np.cov(pts.T, bias=False) if n > 1 else np.zeros((3, 3))
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
            for member, v in out.items():
                code = tx.F3D.get(member)
                if code in self.member_slots:
                    off, _ = self.member_slots[code]
                    values[i, off] = v


class _Windows:
    """A lazy stack's label channel as ``_surface`` reads it: an [z0:z1,
    y0:y1, x0:x1] window as a numpy array, cut plane by plane, so that the
    stack never materialises."""

    def __init__(self, vol):
        self._vol = vol
        self.shape = vol.shape

    def __getitem__(self, key):
        zk, yk, xk = key
        return np.stack([np.asarray(self._vol[z])[yk, xk]
                         for z in range(*zk.indices(self.shape[0]))])
