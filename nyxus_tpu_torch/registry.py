"""Feature-family registry (PyTorch port of nyxus_tpu/registry.py).

The family table below declares every family of the JAX package, in its
registration order and with its metadata (codes, dependencies, device/host
halves, contour and logw needs), so that the dependency closure of a
feature request is the same in both packages.  Only some families have a
device function here; a request that activates any other family raises
``NotImplementedError`` naming it, never silent zeros.

A device function is ``fn(ctx, cfg) -> {enum_member_name: [B] or [B, K]
tensor}`` over one padded ROI batch.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from . import taxonomy as tx
from .config import EngineConfig
from .ops import common as ops_common
from .ops import glcm as ops_glcm
from .ops import gldm as ops_gldm
from .ops import gldzm as ops_gldzm
from .ops import glrlm as ops_glrlm
from .ops import glszm as ops_glszm
from .ops import intensity as ops_intensity
from .ops import ngldm as ops_ngldm
from .ops import ngtdm as ops_ngtdm
from .ops import quant


class BatchContext:
    """Per-bucket shared tensors + lazily built derived data (sorted pixel
    values, binned grey matrices, ...), computed at most once per batch and
    shared across families."""

    def __init__(self, intens, mask, area, vmin, vmax, slide_min, slide_max,
                 heights, widths, cfg: EngineConfig):
        self.intens = intens          # [B, H, W] compute dtype, raw crop
        self.mask = mask              # [B, H, W] bool
        self.area = area              # [B] int
        self.vmin = vmin              # [B] per-ROI min intensity
        self.vmax = vmax              # [B] per-ROI max intensity
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

    def member_code(self, member: str):
        table = {"2d": tx.F2D, "3d": tx.F3D, "imq": tx.FIMQ}[self.domain]
        return table.get(member)

    @property
    def ported(self) -> bool:
        return self.fn is not None and not self.host


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


def families_for(fset: tx.FeatureSet):
    """Names of the activated families, all of which must have a device
    function in this port; raises NotImplementedError naming the others."""
    act = activated_families(fset)
    missing = [n for n in act if not FAMILIES[n].ported]
    if missing:
        raise NotImplementedError(
            "nyxus_tpu_torch does not port these feature families yet: %s"
            % ", ".join(missing))
    return act


# ---------------------------------------------------------------------------
# Family kernels


def _intensity_family(ctx: BatchContext, cfg: EngineConfig):
    # the SIGN of coarse_gray_depth selects the texture binning mode only;
    # histogram bin counts always use the magnitude
    nbins = abs(cfg.coarse_gray_depth)
    return ops_intensity.pixel_intensity_features(
        ctx.sorted_values, ctx.area, ctx.vmin, ctx.vmax,
        ctx.slide_max - ctx.slide_min, nbins, cfg.noval)


def _glcm_family(ctx: BatchContext, cfg: EngineConfig):
    greyinfo = cfg.texture_greydepth("glcm")
    levels = ctx.texture_levels(greyinfo)
    return ops_glcm.glcm_all(
        ctx.masked_intens, levels, ctx.vmin, ctx.vmax,
        cfg.glcm_angles, cfg.glcm_offset, abs(greyinfo), False, greyinfo,
        cfg.noval)


def _n_pixels(ctx: BatchContext):
    return (ctx.masked_intens > 0).reshape(ctx.B, -1).sum(dim=1)


def _texture_setup(ctx: BatchContext, cfg: EngineConfig, family: str):
    """(ng, levels, valid) shared by the GLRLM/NGTDM/GLDM/GLSZM/GLDZM
    families."""
    greyinfo = cfg.texture_greydepth(family)
    levels = ctx.texture_levels(greyinfo)
    if greyinfo > 0:
        valid = ctx.aabb_mask        # MATLAB binning: background participates
    else:
        valid = ctx.aabb_mask & (levels > 0)
    return abs(greyinfo), levels, valid


def _glrlm_family(ctx: BatchContext, cfg: EngineConfig):
    ng, levels, valid = _texture_setup(ctx, cfg, "glrlm")
    dtype = ctx.intens.dtype
    P = ops_glrlm.run_matrices(levels, valid, ng, max(ctx.shape), dtype)
    return ops_glrlm.glrlm_features(P, _n_pixels(ctx), ctx.vmin, ctx.vmax,
                                    cfg.noval, dtype)


def _ngtdm_family(ctx: BatchContext, cfg: EngineConfig):
    ng, levels, valid = _texture_setup(ctx, cfg, "ngtdm")
    return ops_ngtdm.ngtdm_features(levels, valid, ng, ctx.vmin, ctx.vmax,
                                    cfg.noval, ctx.intens.dtype)


def _gldm_family(ctx: BatchContext, cfg: EngineConfig):
    ng, levels, _ = _texture_setup(ctx, cfg, "gldm")
    P = ops_gldm.gldm_matrix(ctx.masked_intens, levels, ng, ctx.intens.dtype)
    return ops_gldm.gldm_features(P, ctx.vmin, ctx.vmax, cfg.noval)


def _ngldm_family(ctx: BatchContext, cfg: EngineConfig):
    return ops_ngldm.ngldm_features(
        ctx.intens, ctx.mask, ctx.vmin, ctx.vmax, abs(cfg.coarse_gray_depth),
        cfg.noval, ctx.intens.dtype)


def _glszm_family(ctx: BatchContext, cfg: EngineConfig):
    _, levels, valid = _texture_setup(ctx, cfg, "glszm")
    if cfg.texture_greydepth("glszm") > 0:
        # MATLAB mode: Np counts the VISITED-marked matrix = whole AABB
        np_pixels = ctx.heights * ctx.widths
    else:
        np_pixels = _n_pixels(ctx)
    return ops_glszm.glszm_features(
        torch.where(valid, levels, 0), valid, np_pixels, ctx.vmin, ctx.vmax,
        cfg.noval, ctx.intens.dtype)


def _gldzm_family(ctx: BatchContext, cfg: EngineConfig):
    _, levels, valid = _texture_setup(ctx, cfg, "gldzm")
    return ops_gldzm.gldzm_features(
        torch.where(valid, levels, 0), valid, ctx.heights, ctx.widths,
        ctx.area, ctx.vmin, ctx.vmax, cfg.noval, ctx.intens.dtype)


FAMILIES["PixelIntensityFeatures"].fn = _intensity_family
FAMILIES["GLCMFeature"].fn = _glcm_family
FAMILIES["GLRLMFeature"].fn = _glrlm_family
FAMILIES["NGTDMFeature"].fn = _ngtdm_family
FAMILIES["GLDMFeature"].fn = _gldm_family
FAMILIES["NGLDMfeature"].fn = _ngldm_family
FAMILIES["GLSZMFeature"].fn = _glszm_family
FAMILIES["GLDZMFeature"].fn = _gldzm_family
