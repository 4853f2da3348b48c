"""Feature-family registry (PyTorch port of nyxus_tpu/registry.py).

The family table below declares every family of the JAX package, in its
registration order and with its metadata (codes, dependencies, device/host
halves, contour and logw needs), so that the dependency closure of a
feature request is the same in both packages.  A family is ported when the
port has every half the JAX family has; every family is.

A device function is ``fn(ctx, cfg) -> {enum_member_name: [B] or [B, K]
tensor}`` over one padded ROI batch; a host function is ``host_fn(hc, cfg)
-> {enum_member_name: [N] or [N, K] numpy array}`` over the host rows of a
slide (``pipeline.runner.HostContext``).
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from . import taxonomy as tx
from .config import EngineConfig
from .ops import binary as ops_binary
from .ops import common as ops_common
from .ops import gabor as ops_gabor
from .ops import glcm as ops_glcm
from .ops import gldm as ops_gldm
from .ops import gldzm as ops_gldzm
from .ops import glrlm as ops_glrlm
from .ops import glszm as ops_glszm
from .ops import ih as ops_ih
from .ops import intensity as ops_intensity
from .ops import moments as ops_moments
from .ops import morphology as ops_morphology
from .ops import ngldm as ops_ngldm
from .ops import ngtdm as ops_ngtdm
from .ops import quant
from .ops import radial as ops_radial
from .ops import zernike as ops_zernike


class BatchContext:
    """Per-bucket shared tensors + lazily built derived data (sorted pixel
    values, binned grey matrices, ...), computed at most once per batch and
    shared across families."""

    def __init__(self, intens, mask, area, vmin, vmax, slide_min, slide_max,
                 heights, widths, cfg: EngineConfig, y0=None, x0=None,
                 logw=None, static_meta=(), hu_offset=None):
        # hu_offset: [B] floor(original slide min) under preserve_hu -- the
        # load-time slope-1 shift IH_* must undo (slideprops.h:48-66,
        # intensity_histogram.cpp:341-372); None/0 otherwise
        self.hu_offset = hu_offset
        # static_meta: (key, value) pairs of per-batch scalars (the IBSI
        # level count "max_int")
        self.static_meta = dict(static_meta)
        self.intens = intens          # [B, H, W] compute dtype, raw crop
        self.mask = mask              # [B, H, W] bool
        self.area = area              # [B] int
        self.vmin = vmin              # [B] per-ROI min intensity
        self.vmax = vmax              # [B] per-ROI max intensity
        self.y0 = y0                  # [B] AABB origin (global coords)
        self.x0 = x0
        self.logw = logw  # [B, H, W] log(sqrt(approx d2 to contour) + eps)
        self.slide_min = slide_min    # [B]
        self.slide_max = slide_max    # [B]
        self.heights = heights        # [B] AABB height per ROI
        self.widths = widths          # [B] AABB width per ROI
        self.cfg = cfg
        self._cache: dict = {}

    @property
    def B(self):
        return self.intens.shape[0]

    @property
    def shape(self):
        return tuple(self.intens.shape[1:])

    def cached(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def sorted_values(self):
        """[B, A] per-ROI pixel values ascending, +inf padding."""
        return self.cached(
            "sorted_values",
            lambda: ops_common.sort_masked_values(self.intens, self.mask))

    @property
    def masked_intens(self):
        """[B, H, W] intensities with off-ROI pixels zeroed (the reference's
        AABB ImageMatrix convention)."""
        return self.cached(
            "masked_intens",
            lambda: torch.where(self.mask, self.intens, 0))

    @property
    def aabb_mask(self):
        """[B, H, W] True inside each ROI's AABB (excludes bucket padding)."""
        def build():
            H, W = self.shape
            dev = self.intens.device
            ys = torch.arange(H, dtype=torch.int32, device=dev)
            xs = torch.arange(W, dtype=torch.int32, device=dev)
            return ((ys[None, :, None] < self.heights[:, None, None]) &
                    (xs[None, None, :] < self.widths[:, None, None]))
        return self.cached("aabb_mask", build)

    def texture_levels(self, greyinfo: int):
        """Binned grey levels for a texture family's greyinfo setting."""
        return self.cached(
            ("levels", greyinfo),
            lambda: quant.bin_levels(
                self.masked_intens, self.vmin[:, None, None],
                self.vmax[:, None, None], greyinfo))


@dataclasses.dataclass
class Family:
    name: str                          # reference calculator class name
    codes: typing.Tuple[int, ...]      # provided global feature codes
    device: bool = False               # the JAX package has a device kernel
    host: bool = False                 # the JAX package has a host function
    domain: str = "2d"                 # member-name enum domain: 2d|3d|imq
    needs_contour: bool = False        # pipeline must build contours for it
    deps: typing.Tuple[str, ...] = ()  # dependency feature member names
    host_needs_contour: bool = True    # host fn reads contours
    needs_logw: bool = False           # device kernel consumes the logw plane
    fn: typing.Callable = None         # the port's device function, if any
    host_fn: typing.Callable = None    # the port's host function, if any

    def member_code(self, member: str):
        table = {"2d": tx.F2D, "3d": tx.F3D, "imq": tx.FIMQ}[self.domain]
        return table.get(member)


FAMILIES: dict = {}


def _declare(name: str, device=False, host=False, extra_codes=(),
             domain="2d", needs_contour=False, deps=(),
             host_needs_contour=True, needs_logw=False):
    codes = tuple(tx.CLASS_FEATURES.get(name, ())) + tuple(extra_codes)
    FAMILIES[name] = Family(name, codes, device, host, domain, needs_contour,
                            tuple(deps), host_needs_contour, needs_logw)


# the JAX package's registrations (nyxus_tpu/registry.py), in its order
_declare("PixelIntensityFeatures", device=True,
         extra_codes=(tx.F2D["HISTOGRAM"],))
_declare("IntensityHistogramFeatures", device=True)
_declare("GLCMFeature", device=True)
_declare("GLRLMFeature", device=True)
_declare("NGTDMFeature", device=True)
_declare("GLDMFeature", device=True)
_declare("NGLDMfeature", device=True)
_declare("GLSZMFeature", device=True)
_declare("GLDZMFeature", device=True)
_declare("BasicMorphologyFeatures", device=True)
_declare("EllipseFittingFeature", device=True)
_declare("ErosionPixelsFeature", device=True, deps=("CONVEX_HULL_AREA",))
_declare("EulerNumberFeature", device=True)
_declare("FractalDimensionFeature", device=True, host=True,
         deps=("PERIMETER",))
_declare("ExtremaFeature", device=True)
_declare("RoiRadiusFeature", host=True, deps=("PERIMETER",))
_declare("RadialDistributionFeature", host=True, deps=("PERIMETER",))
_declare("Imoms2D_feature", device=True, needs_contour=True,
         deps=("PERIMETER",), needs_logw=True)
_declare("Smoms2D_feature", device=True, needs_contour=True,
         deps=("PERIMETER",), needs_logw=True)
_declare("GaborFeature", device=True)
_declare("ZernikeFeature", device=True)
_declare("ContourFeature", host=True)
_declare("ConvexHullFeature", host=True, deps=("PERIMETER",))
_declare("CaliperFeretFeature", host=True, deps=("CONVEX_HULL_AREA",))
_declare("CaliperMartinFeature", host=True, deps=("CONVEX_HULL_AREA",))
_declare("CaliperNassensteinFeature", host=True, deps=("CONVEX_HULL_AREA",))
_declare("ChordsFeature", host=True)
_declare("EnclosingInscribingCircumscribingCircleFeature", host=True,
         deps=("PERIMETER", "CENTROID_X", "CENTROID_Y"))
_declare("GeodeticLengthThicknessFeature", host=True,
         deps=("AREA_PIXELS_COUNT", "PERIMETER"))
_declare("NeighborsFeature", host=True, deps=("CENTROID_X", "CENTROID_Y"))
_declare("HexagonalityPolygonalityFeature", host=True,
         deps=("NUM_NEIGHBORS", "PERIMETER", "CONVEX_HULL_AREA",
               "STAT_FERET_DIAM_MAX", "STAT_FERET_DIAM_MIN"))
for _imq in ("FocusScoreFeature", "PowerSpectrumFeature", "SaturationFeature",
             "SharpnessFeature"):
    _declare(_imq, host=True, domain="imq", host_needs_contour=False)


def activated_families(fset: tx.FeatureSet):
    """Dependency closure of families needed for the enabled feature set.
    Returns names in registration order."""
    active = {n for n, fam in FAMILIES.items() if fset.any_enabled(fam.codes)}
    changed = True
    while changed:
        changed = False
        for name in list(active):
            for dep_member in FAMILIES[name].deps:
                dep_code = tx.NAME2CODE_2D.get(dep_member)
                for n2, fam2 in FAMILIES.items():
                    if n2 not in active and dep_code in fam2.codes:
                        active.add(n2)
                        changed = True
    return tuple(n for n in FAMILIES if n in active)


def split_host_families(fset: tx.FeatureSet):
    """(pre, post) host families.  ``pre`` families' declared deps avoid
    (transitively) any device-computed member, so they can run on the host
    before the device results are collected; ``post`` families read device
    results (centroids, areas) and must run after collection.  Relative
    order within each tuple preserves the registration order that
    dependency chains rely on (hull <- contour, hexagonality <- neighbors)."""
    act = tuple(activated_families(fset))
    code2fam = {}
    for n in act:
        for c in FAMILIES[n].codes:
            code2fam[c] = n
    memo = {}

    def reads_device(n):
        if n in memo:
            return memo[n]
        memo[n] = False          # cycle guard
        for m in FAMILIES[n].deps:
            code = tx.NAME2CODE_2D.get(m)
            p = code2fam.get(code)
            if p is None:
                continue
            pf = FAMILIES[p]
            if pf.device and (not pf.host
                              or m not in _HOST_PROVIDED.get(p, ())):
                memo[n] = True
                break
            if pf.host and reads_device(p):
                memo[n] = True
                break
        return memo[n]

    host = [n for n in act if FAMILIES[n].host]
    return (tuple(n for n in host if not reads_device(n)),
            tuple(n for n in host if reads_device(n)))


# members produced by the HOST half of mixed device+host families (so a dep
# on these does not force post-collect ordering)
_HOST_PROVIDED = {
    "ContourFeature": ("PERIMETER", "PERIMETER_MM", "EDGE_MEAN_INTENSITY",
                       "EDGE_MAX_INTENSITY", "EDGE_MIN_INTENSITY",
                       "EDGE_STDDEV_INTENSITY", "EDGE_INTEGRATED_INTENSITY"),
    "ConvexHullFeature": ("CONVEX_HULL_AREA", "SOLIDITY"),
}


def contour_needed(fset: tx.FeatureSet):
    return any(FAMILIES[n].needs_contour
               or (FAMILIES[n].host and FAMILIES[n].host_needs_contour)
               for n in activated_families(fset))


# ---------------------------------------------------------------------------
# Family kernels


def _intensity_family(ctx: BatchContext, cfg: EngineConfig):
    # the SIGN of coarse_gray_depth selects the texture binning mode only;
    # histogram bin counts always use the magnitude
    nbins = abs(cfg.coarse_gray_depth)
    return ops_intensity.pixel_intensity_features(
        ctx.sorted_values, ctx.area, ctx.vmin, ctx.vmax,
        ctx.slide_max - ctx.slide_min, nbins, cfg.noval)


def _ih_family(ctx: BatchContext, cfg: EngineConfig):
    dt = ctx.intens.dtype
    if not cfg.ibsi:
        # defensive compute-time gate (intensity_histogram.cpp:305-309);
        # enablement is already IBSI-gated at parse time
        nv = torch.full((ctx.B,), cfg.noval, dtype=dt,
                        device=ctx.intens.device)
        return {m: nv for m in ops_ih.MEMBERS}
    # float-domain map (intensity_histogram.cpp:341-372): HU mode undoes the
    # load-time slope-1 offset (the ORIGINAL pre-shift slide min, carried in
    # ctx.hu_offset -- the in-memory slide min is 0 after the shift);
    # integer non-HU images are a no-op
    if cfg.preserve_hu and ctx.hu_offset is not None:
        poffset = ctx.hu_offset.to(dt)
        pscale = torch.ones_like(poffset)
    else:
        poffset = pscale = None
    return ops_ih.ih_features(ctx.sorted_values, ctx.area, ctx.vmin,
                              ctx.vmax, abs(cfg.coarse_gray_depth),
                              cfg.noval, pscale, poffset)


# matrix cells ([B, angles, ng, ng]) of one GLCM chunk of ROIs
GLCM_CHUNK_CELLS = 1 << 26


def _max_int(ctx: BatchContext):
    """IBSI's raw-level count: the slide max rounded up to a power of two
    (the runner's static_meta)."""
    return int(ctx.static_meta.get("max_int", 256))


def _glcm_family(ctx: BatchContext, cfg: EngineConfig):
    ng_val = None
    if cfg.ibsi:
        greyinfo = 0
        ng = _max_int(ctx)
        symmetric = True
        ng_val = ctx.vmax     # per-ROI Ng (reference sizes by the ROI max)
    else:
        greyinfo = cfg.texture_greydepth("glcm")
        ng = abs(greyinfo)
        symmetric = False
    levels = ctx.texture_levels(greyinfo)
    # [B, angles, ng, ng] matrices and their statistics' temporaries: at
    # raw 12-bit levels (4096) one ROI's matrices are 268 MB, so the family
    # runs over chunks of ROIs; each ROI's values are its own
    na = len(cfg.glcm_angles)
    step = max(1, GLCM_CHUNK_CELLS // (na * ng * ng))
    parts = [ops_glcm.glcm_all(
        ctx.masked_intens[c:c + step], levels[c:c + step],
        ctx.vmin[c:c + step], ctx.vmax[c:c + step], cfg.glcm_angles,
        cfg.glcm_offset, ng, symmetric, greyinfo, cfg.noval,
        None if ng_val is None else ng_val[c:c + step])
        for c in range(0, ctx.B, step)]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _n_pixels(ctx: BatchContext):
    return (ctx.masked_intens > 0).reshape(ctx.B, -1).sum(dim=1)


def _texture_setup(ctx: BatchContext, cfg: EngineConfig, family: str):
    """(greyinfo, ng, levels, valid) shared by the GLRLM/NGTDM/GLDM/GLSZM/
    GLDZM families."""
    if cfg.ibsi:
        greyinfo = 0
        ng = _max_int(ctx)
    else:
        greyinfo = cfg.texture_greydepth(family)
        ng = abs(greyinfo)
    levels = ctx.texture_levels(greyinfo)
    if greyinfo > 0:
        valid = ctx.aabb_mask        # MATLAB binning: background participates
    else:
        # IBSI raw mode and radiomics mode both map background/zero to level 0
        valid = ctx.aabb_mask & (levels > 0)
    return greyinfo, ng, levels, valid


def _glrlm_family(ctx: BatchContext, cfg: EngineConfig):
    _, ng, levels, valid = _texture_setup(ctx, cfg, "glrlm")
    dtype = ctx.intens.dtype
    P = ops_glrlm.run_matrices(levels, valid, ng, max(ctx.shape), dtype)
    return ops_glrlm.glrlm_features(P, _n_pixels(ctx), ctx.vmin, ctx.vmax,
                                    cfg.noval, dtype)


def _ngtdm_family(ctx: BatchContext, cfg: EngineConfig):
    greyinfo, ng, levels, valid = _texture_setup(ctx, cfg, "ngtdm")
    return ops_ngtdm.ngtdm_features(levels, valid, ng, ctx.vmin, ctx.vmax,
                                    cfg.noval, ctx.intens.dtype,
                                    ibsi=greyinfo == 0)


def _gldm_family(ctx: BatchContext, cfg: EngineConfig):
    _, ng, levels, _ = _texture_setup(ctx, cfg, "gldm")
    P = ops_gldm.gldm_matrix(ctx.masked_intens, levels, ng, ctx.intens.dtype)
    return ops_gldm.gldm_features(P, ctx.vmin, ctx.vmax, cfg.noval)


def _ngldm_family(ctx: BatchContext, cfg: EngineConfig):
    if cfg.ibsi:
        n_levels = 0
        nmax = _max_int(ctx)
    else:
        n_levels = abs(cfg.coarse_gray_depth)
        nmax = n_levels  # to_grayscale yields 0..n
    return ops_ngldm.ngldm_features(
        ctx.intens, ctx.mask, ctx.vmin, ctx.vmax, n_levels, nmax, cfg.ibsi,
        cfg.noval, ctx.intens.dtype)


def _glszm_family(ctx: BatchContext, cfg: EngineConfig):
    greyinfo, _, levels, valid = _texture_setup(ctx, cfg, "glszm")
    if greyinfo > 0:
        # MATLAB mode: Np counts the VISITED-marked matrix = whole AABB
        np_pixels = ctx.heights * ctx.widths
    else:
        np_pixels = _n_pixels(ctx)
    return ops_glszm.glszm_features(
        torch.where(valid, levels, 0), valid, np_pixels, ctx.vmin, ctx.vmax,
        cfg.noval, ctx.intens.dtype)


def _gldzm_family(ctx: BatchContext, cfg: EngineConfig):
    _, _, levels, valid = _texture_setup(ctx, cfg, "gldzm")
    return ops_gldzm.gldzm_features(
        torch.where(valid, levels, 0), valid, ctx.heights, ctx.widths,
        ctx.area, ctx.vmin, ctx.vmax, cfg.noval, ctx.intens.dtype)


FAMILIES["PixelIntensityFeatures"].fn = _intensity_family
FAMILIES["IntensityHistogramFeatures"].fn = _ih_family
FAMILIES["GLCMFeature"].fn = _glcm_family
FAMILIES["GLRLMFeature"].fn = _glrlm_family
FAMILIES["NGTDMFeature"].fn = _ngtdm_family
FAMILIES["GLDMFeature"].fn = _gldm_family
FAMILIES["NGLDMfeature"].fn = _ngldm_family
FAMILIES["GLSZMFeature"].fn = _glszm_family
FAMILIES["GLDZMFeature"].fn = _gldzm_family


# ---------------------------------------------------------------------------
# Morphology / geometry


def _basic_morphology_family(ctx: BatchContext, cfg: EngineConfig):
    return ops_morphology.basic_morphology(ctx, cfg)


def _ellipse_family(ctx: BatchContext, cfg: EngineConfig):
    return ops_morphology.ellipse_fitting(ctx, cfg)


def _erosion_family(ctx: BatchContext, cfg: EngineConfig):
    return {
        "EROSIONS_2_VANISH": ops_binary.erosions_to_vanish(
            ctx.mask, ctx.heights, ctx.widths, ctx.intens.dtype),
        # the reference DECLARES this member (erosion.cpp:16) but its
        # save_value never writes it (erosion.cpp:196-199), so the binary
        # emits the fvals default 0.0 for every ROI -- pinned by
        # tests/data/ref_all_320x320_seed11.csv.gz.  Emit the same constant.
        "EROSIONS_2_VANISH_COMPLEMENT": torch.zeros(
            (ctx.B,), dtype=ctx.intens.dtype, device=ctx.intens.device),
    }


def _binary_quads(ctx: BatchContext):
    """K9's quad and box counts, one launch shared by Euler and fractal."""
    return ctx.cached("binary_quads",
                      lambda: ops_binary.binary_quads(ctx.mask))


def _euler_family(ctx: BatchContext, cfg: EngineConfig):
    quads, _ = _binary_quads(ctx)
    return {"EULER_NUMBER": ops_binary.euler_number(
        ctx.mask, ctx.intens.dtype, quads)}


def _fractal_family(ctx: BatchContext, cfg: EngineConfig):
    _, boxes = _binary_quads(ctx)
    return {"FRACT_DIM_BOXCOUNT": ops_binary.fract_dim_boxcount(
        ctx.mask, ctx.heights, ctx.widths, ctx.intens.dtype, boxes)}


def _extrema_family(ctx: BatchContext, cfg: EngineConfig):
    return ops_radial.extrema(ctx, cfg)


# Smoms uses the legacy member names (SPAT_MOMENT_*, HU_M*, ...) while Imoms
# uses the IMOM_* scheme (featureset.h)
_SMOM_RENAME = {
    "RM": "SPAT_MOMENT", "WRM": "WEIGHTED_SPAT_MOMENT",
    "CM": "CENTRAL_MOMENT", "WCM": "WEIGHTED_CENTRAL_MOMENT",
    "NCM": "NORM_CENTRAL_MOMENT", "WNCM": "WT_NORM_CTR_MOM",
    "NRM": "NORM_SPAT_MOMENT",
}


def _moments_family(prefix):
    # K10's planes of the family: the weights, then weights * logw
    own, weighted = (1, 2) if prefix == "IMOM" else (0, 3)

    def fn(ctx: BatchContext, cfg: EngineConfig):
        ms = ops_moments.moment_sums(ctx)
        w = ms.raw.shape[1] > weighted
        out = ops_moments.moments_all(
            ms.raw[:, own], ms.central[:, own], prefix, ctx.intens.dtype,
            ms.raw[:, weighted] if w else None,
            ms.central[:, weighted] if w else None)
        if prefix == "SMOM":
            renamed = {}
            for k, v in out.items():
                tag = k[len("SMOM_"):]
                if tag.startswith("WHU"):
                    renamed["WEIGHTED_HU_M" + tag[3:]] = v
                elif tag.startswith("HU"):
                    renamed["HU_M" + tag[2:]] = v
                else:
                    kind, pq = tag.rsplit("_", 1)
                    renamed["%s_%s" % (_SMOM_RENAME[kind], pq)] = v
            return renamed
        return out
    return fn


def _gabor_family(ctx: BatchContext, cfg: EngineConfig):
    return ops_gabor.gabor_features(ctx.masked_intens, ctx.heights,
                                    ctx.widths, ctx.vmin, ctx.vmax, cfg,
                                    ctx.intens.dtype)


def _zernike_family(ctx: BatchContext, cfg: EngineConfig):
    return ops_zernike.zernike_features(
        ctx.masked_intens, ctx.heights, ctx.widths, ctx.vmin, ctx.vmax,
        cfg.noval, ctx.intens.dtype, ops_moments.moment_sums(ctx).raw[:, 1])


FAMILIES["BasicMorphologyFeatures"].fn = _basic_morphology_family
FAMILIES["EllipseFittingFeature"].fn = _ellipse_family
FAMILIES["ErosionPixelsFeature"].fn = _erosion_family
FAMILIES["EulerNumberFeature"].fn = _euler_family
FAMILIES["FractalDimensionFeature"].fn = _fractal_family
FAMILIES["ExtremaFeature"].fn = _extrema_family
FAMILIES["Imoms2D_feature"].fn = _moments_family("IMOM")
FAMILIES["Smoms2D_feature"].fn = _moments_family("SMOM")
FAMILIES["GaborFeature"].fn = _gabor_family
FAMILIES["ZernikeFeature"].fn = _zernike_family


# ---------------------------------------------------------------------------
# Host families (sequential / contour-based; the reference runs these on
# CPU too).  numpy only, as the JAX package has them.


def _hf(fn_name):
    def fn(hc, cfg):
        from .pipeline import hostfeats
        return getattr(hostfeats, fn_name)(hc, cfg)
    return fn


def _contour_host(hc, cfg):
    """ContourFeature (contour.cpp:935-987), from the geometry pass's
    matrix (the JAX registry's numpy fallback for a missing native library
    is not ported: the port's library builds or raises)."""
    g = hc.geom
    return {"PERIMETER": g[:, 0].copy(),
            "DIAMETER_EQUAL_PERIMETER": g[:, 1].copy(),
            "EDGE_MEAN_INTENSITY": g[:, 2].copy(),
            "EDGE_STDDEV_INTENSITY": g[:, 3].copy(),
            "EDGE_MAX_INTENSITY": g[:, 4].copy(),
            "EDGE_MIN_INTENSITY": g[:, 5].copy(),
            "EDGE_INTEGRATED_INTENSITY": g[:, 6].copy()}


def _fractal_perimeter_host(hc, cfg):
    """FRACT_DIM_PERIMETER (fractal_dim.cpp:96-125), from the geometry
    pass's matrix."""
    from .pipeline.hostfeats import _GC_FRACT
    return {"FRACT_DIM_PERIMETER": hc.geom[:, _GC_FRACT].copy()}


FAMILIES["FractalDimensionFeature"].host_fn = _fractal_perimeter_host
# ROI radius and radial distribution consume the reference's APPROXIMATE
# ordered-contour distance search (pixel.cpp:36-143); host families over the
# native approx-distance kernel
FAMILIES["RoiRadiusFeature"].host_fn = _hf("roi_radius")
FAMILIES["RadialDistributionFeature"].host_fn = _hf("radial_distribution")
FAMILIES["ContourFeature"].host_fn = _contour_host
FAMILIES["ConvexHullFeature"].host_fn = _hf("convex_hull_features")
FAMILIES["CaliperFeretFeature"].host_fn = _hf("caliper_feret")
FAMILIES["CaliperMartinFeature"].host_fn = _hf("caliper_martin")
FAMILIES["CaliperNassensteinFeature"].host_fn = _hf("caliper_nassenstein")
FAMILIES["ChordsFeature"].host_fn = _hf("chords")
FAMILIES["EnclosingInscribingCircumscribingCircleFeature"].host_fn = \
    _hf("circle_features")
FAMILIES["GeodeticLengthThicknessFeature"].host_fn = _hf("geodetic_features")
FAMILIES["NeighborsFeature"].host_fn = _hf("neighbors_features")
FAMILIES["HexagonalityPolygonalityFeature"].host_fn = \
    _hf("hexagonality_features")


# ---------------------------------------------------------------------------
# IMQ (image quality) families -- whole-slide oriented, host-side numpy and
# scipy (nyxus_tpu/registry.py:600-660); an oversized row's values come from
# the streamed phase-3 pass (pipeline/imq_streamed.py)


def _imq_crop(hc, i):
    import numpy as np
    if not hc.pixels_ok(i):     # oversized: no dense crop; IMQ unassigned
        return np.zeros((1, 1))
    ii, m = hc.pair_crop(i)
    return np.where(m, ii, 0)


def _focus_host(hc, cfg):
    import numpy as np
    from .ops import imq
    n = len(hc.recs)
    fs = np.zeros(n)
    lfs = np.zeros(n)
    for i in range(n):
        fs[i], lfs[i] = imq.focus_score(_imq_crop(hc, i))
    return {"FOCUS_SCORE": fs, "LOCAL_FOCUS_SCORE": lfs}


def _powerspectrum_host(hc, cfg):
    import numpy as np
    from .ops import imq
    return {"POWER_SPECTRUM_SLOPE": np.array(
        [imq.power_spectrum_slope(_imq_crop(hc, i)) for i in range(len(hc.recs))])}


def _saturation_host(hc, cfg):
    import numpy as np
    from .ops import imq
    n = len(hc.recs)
    mn = np.zeros(n)
    mx = np.zeros(n)
    for i in range(n):
        mn[i], mx[i] = imq.saturation(_imq_crop(hc, i))
    return {"MIN_SATURATION": mn, "MAX_SATURATION": mx}


def _sharpness_host(hc, cfg):
    import numpy as np
    from .ops import imq
    return {"SHARPNESS": np.array(
        [imq.sharpness(_imq_crop(hc, i)) for i in range(len(hc.recs))])}


FAMILIES["FocusScoreFeature"].host_fn = _focus_host
FAMILIES["PowerSpectrumFeature"].host_fn = _powerspectrum_host
FAMILIES["SaturationFeature"].host_fn = _saturation_host
FAMILIES["SharpnessFeature"].host_fn = _sharpness_host
