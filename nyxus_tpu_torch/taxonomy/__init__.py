# Copied verbatim from nyxus_tpu/taxonomy/__init__.py (that package imports jax); pinned by tests/test_torch_tables.py.
"""Feature taxonomy: the public feature-code space, names, groups, and
request-string parsing.

Mirrors the reference's contract (reference: src/nyx/featureset.{h,cpp},
src/nyx/env_features.cpp:200-530) over a single global integer code space:

* 2D feature codes occupy ``[0, FEATURE2D_COUNT)``
* 3D feature codes occupy ``[FEATURE2D_COUNT, FEATURE3D_COUNT)``
* IMQ feature codes occupy ``[FEATURE3D_COUNT, FEATUREIMQ_COUNT)``

User-facing behavior reproduced here:

* feature request strings are uppercased, comma-split, trimmed
  (reference: environment.cpp:858-861)
* a leading ``+``/``-`` enables/disables a feature or group
  (reference: featureset.cpp:964-1021)
* group nicknames (``*ALL*``, ``*ALL_GLCM*``, ...) expand to per-calculator
  feature lists (reference: env_features.cpp:200-430)
* the IH_* family is gated behind IBSI mode (reference: env_features.cpp:514-527)
* output/display name of a code is the alphabetically-first alias (the
  reference iterates a std::map, reference: featureset.cpp getEnabledFeatures)
"""

from __future__ import annotations

import numpy as np

from . import _data

# ---------------------------------------------------------------------------
# Code space

FEATURE2D_COUNT = _data.FEATURE2D_COUNT          # 539
FEATURE3D_COUNT = _data.FEATURE3D_COUNT          # 752 (end of 3D range)
TOTAL_CODES = _data.FEATUREIMQ_COUNT             # 758 (end of IMQ range)

F2D = dict(_data.FEATURE2D_CODES)                # member -> global code
F3D = dict(_data.FEATURE3D_CODES)
FIMQ = dict(_data.FEATUREIMQ_CODES)
ALL_MEMBERS = {**F2D, **F3D, **FIMQ}             # enum member name -> code

# user-facing name -> code, per domain (reference keeps three separate maps).
# Duplicate names keep the FIRST entry: std::map initializer-list semantics
# (featureset.cpp:148-152 lists stale duplicates that never take effect).
def _first_wins(pairs, table):
    out = {}
    for n, m in pairs:
        out.setdefault(n, table[m])
    return out


NAME2CODE_2D = _first_wins(_data.FEATURE2D_NAMES, F2D)
NAME2CODE_3D = _first_wins(_data.FEATURE3D_NAMES, F3D)
NAME2CODE_IMQ = _first_wins(_data.FEATUREIMQ_NAMES, FIMQ)

GROUP2D = {n: m for n, m in _data.FGROUP2D_NAMES}    # nickname -> Fgroup2D member
GROUP3D = {n: m for n, m in _data.FGROUP3D_NAMES}
GROUPIMQ = {n: m for n, m in _data.FGROUPIMQ_NAMES}

# calculator class name -> list of global feature codes
_ENUM_TABLES = {"Feature2D": F2D, "Feature3D": F3D, "FeatureIMQ": FIMQ}
CLASS_FEATURES = {
    cls: [_ENUM_TABLES[en][m] for en, m in members if m in _ENUM_TABLES[en]]
    for cls, members in _data.CLASS_FEATURESETS.items()
}

# GLCM/GLRLM features that are NOT emitted per-angle (scalar _AVE variants)
NONANGLED_GLCM = {F2D[m] for m in _data.NONANGLED["GLCMFeature"]}
NONANGLED_GLRLM = {F2D[m] for m in _data.NONANGLED["GLRLMFeature"]}


def _canonical_names() -> dict:
    """code -> display name: first alias in C++ std::map (byte-wise) order."""
    out = {}
    for table in (NAME2CODE_2D, NAME2CODE_3D, NAME2CODE_IMQ):
        for name in sorted(table):
            code = table[name]
            out.setdefault(code, name)
    return out


CANONICAL_NAME = _canonical_names()


def display_name(code: int) -> str:
    """User-facing column/base name for a feature code."""
    try:
        return CANONICAL_NAME[code]
    except KeyError:
        if code < FEATURE2D_COUNT:
            return "2D-feature%d" % code
        if code < FEATURE3D_COUNT:
            return "3D-feature%d" % code
        return "IMQ-feature%d" % code


# ---------------------------------------------------------------------------
# Group nickname -> class list (reference: env_features.cpp:211-337, 343-460)

_GROUP2D_CLASSES = {
    "FG2_WHOLESLIDE": [
        "ContourFeature", "PixelIntensityFeatures", "GLCMFeature", "GLDMFeature",
        "GLRLMFeature", "GLSZMFeature", "NGLDMfeature", "NGTDMFeature",
        "GaborFeature", "Imoms2D_feature", "RadialDistributionFeature",
        "ZernikeFeature",
    ],
    "FG2_NEIG": ["NeighborsFeature"],
    "FG2_INTENSITY": ["PixelIntensityFeatures"],
    "FG2_IH": ["IntensityHistogramFeatures"],
    "FG2_MORPHOLOGY": [
        "BasicMorphologyFeatures", "EnclosingInscribingCircumscribingCircleFeature",
        "ContourFeature", "ConvexHullFeature", "FractalDimensionFeature",
        "GeodeticLengthThicknessFeature", "NeighborsFeature", "RoiRadiusFeature",
        "EllipseFittingFeature", "EulerNumberFeature", "ExtremaFeature",
        "ErosionPixelsFeature", "CaliperFeretFeature", "CaliperMartinFeature",
        "CaliperNassensteinFeature", "ChordsFeature",
    ],
    "FG2_BASIC_MORPHOLOGY": ["BasicMorphologyFeatures"],
    "FG2_GLCM": ["GLCMFeature"],
    "FG2_GLRLM": ["GLRLMFeature"],
    "FG2_GLDZM": ["GLDZMFeature"],
    "FG2_GLSZM": ["GLSZMFeature"],
    "FG2_GLDM": ["GLDMFeature"],
    "FG2_NGLDM": ["NGLDMfeature"],
    "FG2_NGTDM": ["NGTDMFeature"],
    "FG2_GEOMOMENTS": ["Smoms2D_feature", "Imoms2D_feature"],
    "FG2_GEOMOMENTS_I": ["Imoms2D_feature"],
    "FG2_GEOMOMENTS_S": ["Smoms2D_feature"],
    # FG2_BUT_GABOR / FG2_ALL_BUT_GLCM are recognized nicknames with no
    # expansion in the reference -> requesting them raises (parity quirk).
}

_GROUP3D_CLASSES = {
    "FG3_ALL": [
        "D3_VoxelIntensityFeatures", "D3_SurfaceFeature", "D3_GLCM_feature",
        "D3_GLDM_feature", "D3_GLDZM_feature", "D3_GLRLM_feature",
        "D3_GLSZM_feature", "D3_NGLDM_feature", "D3_NGTDM_feature",
    ],
    "FG3_INTENSITY": ["D3_VoxelIntensityFeatures"],
    "FG3_MORPHOLOGY": ["D3_SurfaceFeature"],
    "FG3_TEXTURE": [
        "D3_GLCM_feature", "D3_GLDM_feature", "D3_GLDZM_feature",
        "D3_GLRLM_feature", "D3_GLSZM_feature", "D3_NGLDM_feature",
        "D3_NGTDM_feature",
    ],
    "FG3_GLCM": ["D3_GLCM_feature"],
    "FG3_GLDM": ["D3_GLDM_feature"],
    "FG3_GLDZM": ["D3_GLDZM_feature"],
    "FG3_GLSZM": ["D3_GLSZM_feature"],
    "FG3_GLRLM": ["D3_GLRLM_feature"],
    "FG3_NGLDM": ["D3_NGLDM_feature"],
    "FG3_NGTDM": ["D3_NGTDM_feature"],
}


class FeatureSet:
    """Bitmask of enabled feature codes over the global code space."""

    def __init__(self):
        self.enabled = np.zeros(TOTAL_CODES, dtype=bool)

    def enable(self, codes, on=True):
        if np.isscalar(codes):
            codes = [codes]
        for c in codes:
            if c < 0:
                self.enabled[-c] = False
            else:
                self.enabled[c] = on

    def enable_class(self, cls: str, on=True):
        self.enabled[CLASS_FEATURES[cls]] = on

    def is_enabled(self, code: int) -> bool:
        return bool(self.enabled[code])

    def any_enabled(self, codes) -> bool:
        return bool(self.enabled[list(codes)].any())

    def enabled_in_order(self):
        """[(display_name, code)] of enabled features in ascending code order
        (the output-column order contract)."""
        codes = np.nonzero(self.enabled)[0]
        return [(display_name(int(c)), int(c)) for c in codes]


def _split_sign(token: str):
    """Strip a leading +/- set operator. Returns (name, enable)."""
    if token[:1] in ("+", "-"):
        return token[1:], token[0] == "+"
    return token, True


def _expand_2d_group(fset: FeatureSet, token: str) -> bool:
    name, enable = _split_sign(token)
    grp = GROUP2D.get(name)
    if grp is None:
        return False
    if grp == "FG2_ALL":
        # reference always enables here, regardless of sign
        fset.enabled[:FEATURE2D_COUNT] = True
        return True
    classes = _GROUP2D_CLASSES.get(grp)
    if classes is None:
        return False  # recognized nickname without expansion (BUT_GABOR etc.)
    for cls in classes:
        fset.enable_class(cls, enable)
    return True


def _expand_3d_group(fset: FeatureSet, token: str) -> bool:
    name, enable = _split_sign(token)
    grp = GROUP3D.get(name)
    if grp is None:
        return False
    classes = _GROUP3D_CLASSES.get(grp)
    if classes is None:
        return False
    for cls in classes:
        fset.enable_class(cls, enable)
    return True


def _expand_imq_group(fset: FeatureSet, token: str) -> bool:
    name, _ = _split_sign(token)
    if name in GROUPIMQ:
        for code in NAME2CODE_IMQ.values():
            fset.enabled[code] = True
        return True
    return False


def parse_feature_request(features, dim=2, imq=False, ibsi=False):
    """Expand a user feature request into a FeatureSet.

    ``features``: list of strings or a single comma-separated string.
    Mirrors Environment::expand_featuregroups (env_features.cpp:462-530).
    """
    if isinstance(features, str):
        features = features.split(",")
    tokens = [t.strip().upper() for t in features if t.strip()]

    fset = FeatureSet()
    for tok in tokens:
        if imq:
            if _expand_imq_group(fset, tok):
                # reference quirk: an IMQ group match returns immediately,
                # skipping any remaining tokens (env_features.cpp:471-473)
                return fset
            name, enable = _split_sign(tok)
            code = NAME2CODE_IMQ.get(name)
            if code is None:
                raise ValueError(
                    "Error: '%s' is not a valid Image Quality feature name" % tok)
            fset.enable(code if enable else -code)
            continue

        if dim == 2 and _expand_2d_group(fset, tok):
            continue
        if dim == 3 and _expand_3d_group(fset, tok):
            continue

        name, enable = _split_sign(tok)
        if dim == 2:
            code = NAME2CODE_2D.get(name)
            if code is None:
                raise ValueError("Error: '%s' is not a valid 2D feature name" % tok)
        else:
            code = NAME2CODE_3D.get(name)
            if code is None:
                raise ValueError("Error: '%s' is not a valid 3D feature name" % tok)
        fset.enable(code if enable else -code)

    # IBSI gate on the IH_* family (env_features.cpp:514-527)
    if dim == 2 and not ibsi:
        ih = CLASS_FEATURES["IntensityHistogramFeatures"]
        fset.enabled[ih] = False

    return fset
