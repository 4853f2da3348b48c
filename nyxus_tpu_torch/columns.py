# Copied verbatim from nyxus_tpu/columns.py (that package imports jax); pinned by tests/test_torch_tables.py.
"""Output column contract: expand enabled features into column names and
per-feature value widths.

Reproduces the reference's header/value assembly (src/nyx/output_2_buffer.cpp:41-260):
columns are ``intensity_image, mask_image, ROI_label, t_index`` followed by one
column per enabled feature in ascending code order, where multi-valued
features expand as:

* GLCM angled features       -> ``NAME_<angle>`` per configured GLCM angle
* GLRLM angled features      -> ``NAME_<angle>`` per rotation angle {0,45,90,135}
* GABOR                      -> ``GABOR_<i>`` per filter pair
* FRAC_AT_D / MEAN_FRAC / RADIAL_CV -> ``NAME_<i>`` for i in 0..7
* ZERNIKE2D                  -> ``ZERNIKE2D_Z<i>`` for i in 0..29
* HISTOGRAM                  -> ``HISTOGRAM_BIN_<i>`` for i in 0..nbins-1
"""

from __future__ import annotations

from . import taxonomy as tx
from .config import EngineConfig

GLRLM_ROT_ANGLES = (0, 45, 90, 135)
N_RADIAL = 8          # reference: radial_distribution.h:37-39
N_ZERNIKE = 30        # reference: zernike.h:30

COL_INTENSITY = "intensity_image"
COL_MASK = "mask_image"
COL_LABEL = "ROI_label"
COL_T = "t_index"

_GLCM_SET = set(tx.CLASS_FEATURES["GLCMFeature"])
_GLRLM_SET = set(tx.CLASS_FEATURES["GLRLMFeature"])


def feature_width(code: int, cfg: EngineConfig) -> int:
    """Number of output values (columns) for a feature code."""
    name = tx.display_name(code)
    if code in _GLCM_SET and code not in tx.NONANGLED_GLCM:
        return len(cfg.glcm_angles)
    if code in _GLRLM_SET and code not in tx.NONANGLED_GLRLM:
        return len(GLRLM_ROT_ANGLES)
    if name == "GABOR":
        return len(cfg.gabor_freqs)
    if name in ("FRAC_AT_D", "MEAN_FRAC", "RADIAL_CV"):
        return N_RADIAL
    if name == "ZERNIKE2D":
        return N_ZERNIKE
    if name == "HISTOGRAM":
        return cfg.coarse_gray_depth
    return 1


def feature_subcolumns(code: int, cfg: EngineConfig):
    """Column names contributed by a feature code, in order."""
    name = tx.display_name(code)
    if code in _GLCM_SET and code not in tx.NONANGLED_GLCM:
        return ["%s_%d" % (name, a) for a in cfg.glcm_angles]
    if code in _GLRLM_SET and code not in tx.NONANGLED_GLRLM:
        return ["%s_%d" % (name, a) for a in GLRLM_ROT_ANGLES]
    if name == "GABOR":
        return ["%s_%d" % (name, i) for i in range(len(cfg.gabor_freqs))]
    if name in ("FRAC_AT_D", "MEAN_FRAC", "RADIAL_CV"):
        return ["%s_%d" % (name, i) for i in range(N_RADIAL)]
    if name == "ZERNIKE2D":
        return ["%s_Z%d" % (name, i) for i in range(N_ZERNIKE)]
    if name == "HISTOGRAM":
        return ["%s_BIN_%d" % (name, i) for i in range(cfg.coarse_gray_depth)]
    return [name]


def build_header(fset: tx.FeatureSet, cfg: EngineConfig):
    """(all_column_names, feature_slots) where feature_slots is
    [(code, width)] in output order for the numeric part after ROI_label,t_index."""
    cols = [COL_INTENSITY, COL_MASK, COL_LABEL, COL_T]
    slots = []
    for _, code in fset.enabled_in_order():
        sub = feature_subcolumns(code, cfg)
        cols.extend(sub)
        slots.append((code, len(sub)))
    return cols, slots
